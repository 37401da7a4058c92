"""The PyTorch port's continuous-batching scheduler
(kubeflow_tpu_torch.models.scheduler) and its serving routes, against
the JAX reference's DecodeScheduler and the port's own lock path, on the
CPU at llama_debug size.

The contract: a request generates the tokens it generates alone on the
lock path, whatever else shares the slot pool (greedy and seeded
sampling, mixed lengths, EOS mid-flight while freed slots refill).  The
port's sampling draws from torch generators, not JAX keys, so seeded
requests are held against the port's own sequential ``generate``;
greedy tokens are held against the JAX package too.
"""
import dataclasses
import json
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.scheduler import DecodeScheduler as JaxScheduler
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.generate import generate, row_generators
from kubeflow_tpu_torch.models.layers import KVCache
from kubeflow_tpu_torch.models.scheduler import (
    PRIORITY_CLASSES,
    DeadlineExceeded,
    DecodeScheduler,
    PendingRequest,
)
from kubeflow_tpu_torch.models.serve import GenerationService, create_app

MAX_SEQ = 64


@pytest.fixture(scope="module")
def jax_model_and_params():
    cfg = dataclasses.replace(JAX_CONFIGS["llama_debug"], max_seq_len=MAX_SEQ)
    model = JaxLlama(cfg)
    params = model.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))[
        "params"]
    return model, params


@pytest.fixture(scope="module")
def model(jax_model_and_params):
    """The port's llama_debug (f32) with the reference's parameters."""
    _, params = jax_model_and_params
    m = create_model("llama_debug", device="cpu", max_seq_len=MAX_SEQ)
    m.load_state_dict(params_from_jax(jax.device_get(params), m.cfg))
    return m.eval()


def _padded(rows):
    longest = max(len(r) for r in rows)
    prompt = torch.tensor([r + [0] * (longest - len(r)) for r in rows])
    mask = torch.tensor([[True] * len(r) + [False] * (longest - len(r))
                         for r in rows])
    return prompt, mask


def sequential(model, rows, *, seed=0, **kw):
    """The per-request reference: one ``generate`` call with the rows'
    generators, exactly what the lock path runs."""
    prompt, mask = _padded(rows)
    return generate(model, prompt, prompt_mask=mask,
                    generators=row_generators(seed, len(rows), "cpu"),
                    **kw).tolist()


def jax_sequential(jax_model_and_params, rows, **kw):
    jm, params = jax_model_and_params
    longest = max(len(r) for r in rows)
    prompt = jnp.array([r + [0] * (longest - len(r)) for r in rows],
                       jnp.int32)
    mask = jnp.array([[1] * len(r) + [0] * (longest - len(r)) for r in rows],
                     bool)
    return jax.device_get(jax_generate(
        jm, params, prompt, prompt_mask=mask, rng=jax.random.key(0),
        **kw)).tolist()


def run_concurrently(sched, reqs):
    """Submit every (rows, kwargs) from its own thread; outputs in order."""
    outs = {}

    def client(i, rows, kw):
        outs[i] = sched.submit(rows, **kw).result()

    threads = [threading.Thread(target=client, args=(i, r, kw))
               for i, (r, kw) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return [outs[i] for i in range(len(reqs))]


# -- the model's per-row cache_slots mode against the reference's -------------


def test_cache_slots_decode_matches_jax_per_row_mode(
        jax_model_and_params, model):
    """One decode step with rows at different depths: each row writes its
    K/V at its own slot and sees the slots up to it plus its pad row.
    Logits and the written cache match the reference's per-row mode."""
    jm, params = jax_model_and_params
    cfg = model.cfg
    b, length, kvh, hd = 3, 16, cfg.n_kv_heads, cfg.head_dim
    rs = np.random.RandomState(3)
    ks = rs.randn(cfg.n_layers, b, length, kvh, hd).astype(np.float32)
    vs = rs.randn(cfg.n_layers, b, length, kvh, hd).astype(np.float32)
    slots = np.array([0, 7, 15], np.int32)
    pos = np.array([0, 5, 12], np.int32)
    tokens = np.array([3, 100, 250], np.int32)
    pad = np.zeros((b, length), np.float32)
    pad[1, 2:4] = -1e30                  # a prompt's padding slots
    pad[2, 10:] = -1e30                  # and slots past the row's cache
    pad[2, 15] = 0.0
    allowed = np.arange(length)[None] <= slots[:, None]
    bias = np.where(allowed, 0.0, -1e30).astype(np.float32) + pad
    jcache = {f"layer_{i}": {"attn": {
        "cached_key": jnp.asarray(ks[i]), "cached_value": jnp.asarray(vs[i]),
        "cache_index": jnp.zeros((), jnp.int32)}} for i in range(cfg.n_layers)}
    want, jstate = jm.apply(
        {"params": params, "cache": jcache}, jnp.asarray(tokens)[:, None],
        positions=jnp.asarray(pos)[:, None], decode=True,
        mask_bias=jnp.asarray(bias)[:, None, None, :], cache_len=length,
        cache_slots=jnp.asarray(slots), mutable=["cache"])
    cache = KVCache(k=[torch.from_numpy(ks[i].copy())
                       for i in range(cfg.n_layers)],
                    v=[torch.from_numpy(vs[i].copy())
                       for i in range(cfg.n_layers)], index=4)
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens).long()[:, None],
                    positions=torch.from_numpy(pos).long()[:, None],
                    cache=cache, pad_bias=torch.from_numpy(pad),
                    cache_slots=torch.from_numpy(slots).long())
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[:, 0],
                               atol=1e-5, rtol=1e-5)
    assert cache.index == 4              # the per-row mode leaves it
    for i in range(cfg.n_layers):
        np.testing.assert_allclose(
            cache.k[i].numpy(),
            np.asarray(jstate["cache"][f"layer_{i}"]["attn"]["cached_key"]),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            cache.v[i].numpy(),
            np.asarray(jstate["cache"][f"layer_{i}"]["attn"]["cached_value"]),
            atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="single-token"):
        model.layers[0].attn(torch.zeros(b, 2, cfg.dim),
                             torch.zeros(b, 2, dtype=torch.long),
                             cache=cache, bias_rows=torch.zeros(b, length),
                             cache_slots=torch.zeros(b, dtype=torch.long))


# -- the reference's scheduler cases, on the port -----------------------------


def test_single_row_greedy_token_equal(model, jax_model_and_params):
    sched = DecodeScheduler(model, slots=4, slot_len=64, quantum=4)
    rows = [[5, 9, 2, 7]]
    got = sched.submit(rows, max_new_tokens=6).result()
    assert got == sequential(model, rows, max_new_tokens=6)
    assert got == jax_sequential(jax_model_and_params, rows,
                                 max_new_tokens=6)


def test_single_row_seeded_topk_token_equal(model):
    sched = DecodeScheduler(model, slots=4, slot_len=64, quantum=4)
    rows = [[3, 1, 4, 1, 5]]
    got = sched.submit(rows, max_new_tokens=7, temperature=0.8, top_k=8,
                       seed=11).result()
    assert got == sequential(model, rows, max_new_tokens=7, temperature=0.8,
                             top_k=8, seed=11)


def test_multi_row_mixed_length_request(model):
    sched = DecodeScheduler(model, slots=4, slot_len=64, quantum=4)
    rows = [[5, 9], [7, 1, 4, 8], [2]]
    got = sched.submit(rows, max_new_tokens=5).result()
    assert got == sequential(model, rows, max_new_tokens=5)


def test_budget_one_and_immediate_eos(model):
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=4)
    rows = [[5, 9, 2, 7]]
    # n == 1: complete at admission, never takes a slot.
    assert sched.submit(rows, max_new_tokens=1).result() == sequential(
        model, rows, max_new_tokens=1)
    # EOS as the first token: right-padded with EOS without decoding.
    first = sequential(model, rows, max_new_tokens=1)[0][0]
    got = sched.submit(rows, max_new_tokens=5, eos_token=first).result()
    assert got == sequential(model, rows, max_new_tokens=5, eos_token=first)
    assert got[0][1:] == [first] * 4
    stats = sched.stats()
    assert stats["steps_total"] == 0 and stats["prefills_total"] == 2
    assert stats["admitted_total"] == stats["evicted_total"] == 2


MIXED = [
    ([[5, 9, 2, 7]], dict(max_new_tokens=10)),
    ([[1, 2, 3]], dict(max_new_tokens=12)),
    ([[4, 4], [6, 1, 6]], dict(max_new_tokens=6, temperature=0.5, top_k=4,
                               seed=3)),
    ([[8, 8, 8, 8, 8]], dict(max_new_tokens=9)),
    ([[9, 7, 5]], dict(max_new_tokens=4)),
    ([[2, 2, 2]], dict(max_new_tokens=8, temperature=0.9, seed=5)),
]


def _with_eos(model):
    """MIXED with EOS on the first and fifth requests: the first row's
    decode step 4 token, so it finishes mid-flight."""
    eos = sequential(model, [[5, 9, 2, 7]], max_new_tokens=10)[0][4]
    reqs = [(r, dict(kw)) for r, kw in MIXED]
    reqs[0][1]["eos_token"] = eos
    reqs[4][1]["eos_token"] = eos
    return reqs


def test_midflight_eos_evicts_and_refills(model):
    """Seven rows through 2 slots: rows that finish mid-flight free their
    slots for queued rows while the others decode, and every output
    equals the request's own sequential run."""
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=2)
    reqs = _with_eos(model)
    outs = run_concurrently(sched, reqs)
    for (rows, kw), out in zip(reqs, outs):
        assert out == sequential(model, rows, **kw), (rows, kw)
    stats = sched.stats()
    assert stats["admitted_total"] == stats["evicted_total"] == 7
    assert stats["active_rows"] == 0 and stats["queued_rows"] == 0


def test_request_wider_than_pool_pends_rows(model):
    """More rows than slots: the rows decode in waves through the
    pending-insert list, and the outputs still equal."""
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=3)
    rows = [[5, 9], [7, 1], [2, 4], [8, 3], [6, 6]]
    got = sched.submit(rows, max_new_tokens=5).result()
    assert got == sequential(model, rows, max_new_tokens=5)
    assert sched.stats()["evicted_total"] == 5


def test_slot_len_bound_raises(model):
    sched = DecodeScheduler(model, slots=2, slot_len=16, quantum=2)
    with pytest.raises(ValueError, match="slot length"):
        sched.submit([[1] * 10], max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq_len"):
        DecodeScheduler(model, slots=2, slot_len=MAX_SEQ + 1)


def test_knobs_come_from_the_environment(model, monkeypatch):
    monkeypatch.setenv("KFT_SERVE_SLOTS", "3")
    monkeypatch.setenv("KFT_SERVE_SLOT_LEN", "32")
    monkeypatch.setenv("KFT_SERVE_DECODE_QUANTUM", "5")
    monkeypatch.setenv("KFT_SERVE_PIPELINE", "0")
    sched = DecodeScheduler(model)
    assert (sched.slots, sched.slot_len, sched.quantum, sched.pipeline) == (
        3, 32, 5, False)
    monkeypatch.delenv("KFT_SERVE_SLOT_LEN")
    assert DecodeScheduler(model).slot_len == MAX_SEQ


# -- against the reference scheduler, pooled against alone, pipelining --------


def test_greedy_tokens_equal_the_jax_scheduler(model, jax_model_and_params):
    """The same greedy requests through both packages' schedulers (same
    pool, same quantum, parameters converted from the reference): equal
    tokens, also equal to the port's lock path."""
    jm, params = jax_model_and_params
    reqs = [([[5, 9, 2, 7], [1, 2]], dict(max_new_tokens=7)),
            ([[8, 8, 8]], dict(max_new_tokens=11)),
            ([[3, 1, 4, 1, 5, 9, 2, 6]], dict(max_new_tokens=5)),
            ([[7], [200, 17, 4]], dict(max_new_tokens=9))]
    want = run_concurrently(JaxScheduler(jm, params, slots=3, slot_len=64,
                                         quantum=4), reqs)
    got = run_concurrently(DecodeScheduler(model, slots=3, slot_len=64,
                                           quantum=4), reqs)
    assert got == want
    service = GenerationService(model)
    for (rows, kw), out in zip(reqs, got):
        assert service.generate(rows, **kw) == out


def test_seeded_requests_equal_pooled_and_alone(model):
    """Sampled requests: each row draws from its own generator, which
    moves with the row into its slot, so a request's tokens are the same
    pooled with others (and refilled mid-flight) as alone in the pool."""
    reqs = [([[4, 4], [6, 1, 6]], dict(max_new_tokens=9, temperature=0.7,
                                       top_k=5, seed=3)),
            ([[2, 2, 2]], dict(max_new_tokens=12, temperature=1.3, seed=8)),
            ([[9, 7]], dict(max_new_tokens=6, temperature=0.9, top_k=40,
                            seed=3)),
            ([[1, 5, 3, 3]], dict(max_new_tokens=10))]
    pooled = run_concurrently(
        DecodeScheduler(model, slots=3, slot_len=64, quantum=3), reqs)
    alone = DecodeScheduler(model, slots=3, slot_len=64, quantum=3)
    for (rows, kw), out in zip(reqs, pooled):
        assert alone.submit(rows, **kw).result() == out
        assert sequential(model, rows, **kw) == out


def test_pipeline_on_and_off_give_equal_tokens(model):
    reqs = _with_eos(model)
    outs, stats = [], []
    for pipeline in (True, False):
        sched = DecodeScheduler(model, slots=3, slot_len=64, quantum=2,
                                pipeline=pipeline)
        outs.append(run_concurrently(sched, reqs))
        stats.append(sched.stats())
        sched.stop()
    assert outs[0] == outs[1]
    for (rows, kw), out in zip(reqs, outs[0]):
        assert out == sequential(model, rows, **kw)
    assert [s["pipeline"] for s in stats] == [True, False]
    for s in stats:
        assert s["admitted_total"] == s["evicted_total"] == 7
        assert s["steps_total"] % 2 == 0 and s["steps_total"] > 0


def test_pool_steps_read_nothing_on_the_host(model, monkeypatch):
    """A quantum enqueues its steps without reading a tensor back: the
    harvest is the first host read after a dispatch."""
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=4,
                            pipeline=False)
    reads = []
    names = ("tolist", "item", "numpy", "__bool__", "__int__", "__float__",
             "__index__")
    real = {name: getattr(torch.Tensor, name) for name in names}

    def spy(name):
        def wrapped(self, *a, **k):
            reads.append(name)
            return real[name](self, *a, **k)
        return wrapped

    from kubeflow_tpu_torch.models import scheduler as sched_mod

    real_steps = sched_mod.pool_steps

    def watched(*a, **k):
        for name in names:
            setattr(torch.Tensor, name, spy(name))
        try:
            return real_steps(*a, **k)
        finally:
            for name in names:
                setattr(torch.Tensor, name, real[name])

    monkeypatch.setattr(sched_mod, "pool_steps", watched)
    got = sched.submit([[5, 9, 2], [1]], max_new_tokens=7).result()
    assert got == sequential(model, [[5, 9, 2], [1]], max_new_tokens=7)
    assert sched.stats()["steps_total"] == 8
    assert reads == []


# -- QoS: priority classes and deadlines --------------------------------------


def _pending(rows=((1, 2),), **kw):
    kw.setdefault("max_new_tokens", 2)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("top_k", None)
    kw.setdefault("eos_token", None)
    kw.setdefault("seed", 0)
    return PendingRequest([list(r) for r in rows], **kw)


def test_priority_admission_selection_order(model):
    """Lowest priority class pops first, FIFO within a class."""
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=2)
    reqs = []
    for tag, cls in [("b1", "batch"), ("s1", "standard"),
                     ("i1", "interactive"), ("s2", "standard"),
                     ("b2", "batch")]:
        r = _pending(priority=PRIORITY_CLASSES[cls])
        r.tag = tag
        reqs.append(r)
    with sched._cond:
        sched._queue.extend(reqs)
    order = [sched._next_queued(pop=True).tag for _ in range(len(reqs))]
    assert order == ["i1", "s1", "s2", "b1", "b2"]
    assert sched._next_queued(pop=True) is None


def test_expired_queued_request_evicted_at_selection(model):
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=2)
    dead = _pending(deadline=time.monotonic() - 0.01)
    live = _pending()
    with sched._cond:
        sched._queue.extend([dead, live])
    assert sched._next_queued(pop=False) is live
    assert dead.done.is_set()
    with pytest.raises(DeadlineExceeded, match="expired while queued"):
        dead.result()
    assert sched._next_queued(pop=True) is live


def test_submit_deadline_and_priority_ride_through(model):
    sched = DecodeScheduler(model, slots=2, slot_len=64, quantum=2)
    fut = sched.submit([[5, 9]], max_new_tokens=3,
                       deadline=time.monotonic() - 0.001)
    with pytest.raises(DeadlineExceeded):
        fut.result()
    assert sched.alive
    rows = [[5, 9, 2, 7]]
    got = sched.submit(rows, max_new_tokens=4,
                       priority=PRIORITY_CLASSES["batch"],
                       deadline=time.monotonic() + 60.0).result()
    assert got == sequential(model, rows, max_new_tokens=4)


def test_held_queue_admits_by_priority(model):
    """Requests queued while the loop is held are admitted by class: the
    interactive one is prefilled first, whatever its arrival."""
    sched = DecodeScheduler(model, slots=1, slot_len=64, quantum=2)
    order = []
    orig = sched._prefill

    def record(req):
        order.append(req.priority)
        return orig(req)

    sched._prefill = record
    orig_start = sched.start
    sched.start = lambda: None
    futs = [sched.submit([[5, i]], max_new_tokens=3,
                         priority=PRIORITY_CLASSES[c])
            for i, c in enumerate(["batch", "standard", "interactive"])]
    sched.start = orig_start
    sched.start()
    for i, fut in enumerate(futs):
        assert fut.result() == sequential(model, [[5, i]], max_new_tokens=3)
    assert order == [0, 1, 2]


# -- the serving routes -------------------------------------------------------


def _metric(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name))


def _get(app, path):
    status, _, body = app.handle("GET", path, {}, b"")
    return status, body.decode()


def test_scheduler_crash_fails_requests_then_service_falls_back(
        model, monkeypatch):
    """A loop crash fails the in-flight request with the error and marks
    the scheduler dead; the service then serves on the lock path."""
    service = GenerationService(model)
    create_app(service, model_name="llama_debug")  # attaches telemetry
    sched = service._scheduler_or_none()
    assert sched is not None

    def boom(*a, **k):
        raise RuntimeError("injected scheduler fault")

    monkeypatch.setattr(sched, "_run_quantum", boom)
    with pytest.raises(RuntimeError, match="injected scheduler fault"):
        service.generate([[5, 9, 2]], max_new_tokens=4)
    assert not sched.alive
    stats = sched.stats()
    assert stats["admitted_total"] == stats["evicted_total"] == 1
    assert service._scheduler_or_none() is None
    out = service.generate([[5, 9, 2]], max_new_tokens=4)
    assert out == sequential(model, [[5, 9, 2]], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="dead"):
        sched.submit([[1]], max_new_tokens=2)


def test_serve_queue_depth_counts_pending_rows(model):
    """serve_queue_depth counts queued rows (not lock waiters) while the
    loop is held, and drains to 0; the counters then balance."""
    service = GenerationService(model)
    app = create_app(service, model_name="llama_debug")
    sched = service._scheduler_or_none()
    orig_start = sched.start
    sched.start = lambda: None  # hold the loop: submissions only queue
    results = {}
    threads = [threading.Thread(
        target=lambda i=i: results.update(
            {i: service.generate([[5 + i, 9, 2], [1]], max_new_tokens=4)}))
        for i in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            text = _get(app, "/metrics")[1]
            if "serve_queue_depth 6.0" in text:
                break
            time.sleep(0.02)
        else:
            pytest.fail(f"queue depth never reached 6: {text}")
    finally:
        sched.start = orig_start
        sched.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    text = _get(app, "/metrics")[1]
    assert "serve_queue_depth 0.0" in text
    assert "serve_scheduler_admitted_rows_total 6.0" in text
    assert "serve_scheduler_evicted_rows_total 6.0" in text
    assert "serve_decode_slots_active 0.0" in text
    assert "serve_decode_slots 8.0" in text
    for i in range(3):
        assert results[i] == sequential(model, [[5 + i, 9, 2], [1]],
                                        max_new_tokens=4)


def test_http_outputs_identical_scheduler_on_vs_off(model, monkeypatch):
    """KFT_SERVE_SCHEDULER=0 pins the lock path; both engines serve the
    same HTTP responses, greedy and seeded."""
    body = json.dumps({"tokens": [[5, 9, 2], [7, 7]], "max_new_tokens": 5,
                       "temperature": 0.7, "top_k": 5,
                       "seed": 9}).encode()
    on_service = GenerationService(model)
    on = create_app(on_service, model_name="m")
    r_on = on.handle("POST", "/v1/generate", {}, body)
    assert on_service._scheduler is not None
    assert on_service._scheduler.stats()["evicted_total"] >= 2
    monkeypatch.setenv("KFT_SERVE_SCHEDULER", "0")
    off_service = GenerationService(model)
    off = create_app(off_service, model_name="m")
    r_off = off.handle("POST", "/v1/generate", {}, body)
    assert r_on[0] == r_off[0] == 200
    assert json.loads(r_on[2])["tokens"] == json.loads(r_off[2])["tokens"]
    assert off_service._scheduler is None      # really the lock path
    pinned = GenerationService(model, use_scheduler=False)
    create_app(pinned, model_name="m")
    monkeypatch.delenv("KFT_SERVE_SCHEDULER")
    assert pinned._scheduler_or_none() is None
    # Library use (no create_app) never starts a scheduler thread.
    assert GenerationService(model)._scheduler_or_none() is None


def test_scheduled_traces_debug_serve_and_ready(model):
    service = GenerationService(model)
    app = create_app(service, model_name="llama_debug")
    assert json.loads(_get(app, "/debug/serve")[1])["engine"] is None
    status, ready = _get(app, "/readyz")
    assert status == 200 and json.loads(ready)["ready"] is True
    body = json.dumps({"tokens": [[4, 5]], "max_new_tokens": 3}).encode()
    assert app.handle("POST", "/v1/generate", {}, body)[0] == 200
    traces = json.loads(_get(app, "/debug/traces?n=1")[1])["traces"]
    assert [s["name"] for s in traces[-1]["spans"]] == [
        "admit", "queue", "prefill", "decode"]
    info = json.loads(_get(app, "/debug/serve")[1])
    assert info["engine"] == "DecodeScheduler"
    assert info["scheduler"]["admitted_total"] == 2     # warm + request
    assert info["scheduler"]["alive"] is True
    # A prompt + budget past the slot length is a 400, not a crash.
    too_long = json.dumps({"tokens": [[1] * 40], "max_new_tokens": 30})
    status, _, text = app.handle("POST", "/v1/generate", {},
                                 too_long.encode())
    assert status == 400 and b"slot length" in text


def test_concurrent_http_requests_pool_and_balance_counters(model):
    """More request threads than cores over a real socket, with a short
    switch interval: every response equals the request's sequential run,
    and the scheduler's counters balance."""
    service = GenerationService(model)
    srv = create_app(service, model_name="llama_debug").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    prompts = [[5, 9, 2], [7, 1, 4, 8], [3, 3, 3], [9], [2, 6, 4, 1, 5]]

    def call(i):
        body = {"tokens": [prompts[i % 5]], "max_new_tokens": 3 + i % 4,
                "temperature": 0.8 if i % 3 == 0 else 0.0, "seed": i}
        req = urllib.request.Request(base + "/v1/generate",
                                     data=json.dumps(body).encode())
        with opener.open(req, timeout=60) as resp:
            return json.loads(resp.read())["tokens"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(call, range(16)))
    finally:
        sys.setswitchinterval(old)
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    for i, out in enumerate(got):
        kw = dict(max_new_tokens=3 + i % 4, seed=i,
                  temperature=0.8 if i % 3 == 0 else 0.0)
        assert out == sequential(model, [prompts[i % 5]], **kw), i
    stats = service._scheduler.stats()
    assert stats["admitted_total"] == stats["evicted_total"] == 16
    assert stats["active_rows"] == 0 and stats["queued_rows"] == 0
