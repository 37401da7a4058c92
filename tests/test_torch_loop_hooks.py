"""The port's training-loop hooks against the reference's on the CPU: eval
every N steps with ``eval_``-prefixed means, the token count of a batch,
the step spans, the slow-step counter and dump, the one-shot profile of
the step after a slow one, and ``train/profiling.py`` (``profile_trace``,
``profile_steps``, ``trace_summary``, which refuses a trace without
device kernels unless told to read host ops)."""
import logging
import os
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import loop as jax_loop
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.telemetry import compute as ctel
from kubeflow_tpu_torch.train import loop, profiling, steps


def _count_step(state, batch):
    return state + 1, {"loss": torch.tensor(float(batch.sum()))}


def _eval_fn(state, batch):
    return {"loss": float(batch.sum()) + state, "acc": 0.5}


def _run_both(cfg_kw, total=6):
    """The same loop config, steps and eval through both packages."""
    batches = [torch.ones(2, 4, dtype=torch.int32) * i for i in range(10)]
    evals = [torch.ones(2, 4) * i for i in range(5)]
    _, port = loop.train_loop(
        0, _count_step, batches, loop.LoopConfig(total_steps=total,
                                                 **cfg_kw),
        eval_fn=_eval_fn, eval_batches=lambda: iter(evals),
        on_log=lambda n, v: None)
    _, ref = jax_loop.train_loop(
        0, lambda s, b: (s + 1, {"loss": float(np.asarray(b).sum())}),
        [np.asarray(b) for b in batches],
        jax_loop.LoopConfig(total_steps=total, **cfg_kw),
        eval_fn=lambda s, b: _eval_fn(s, torch.as_tensor(np.asarray(b))),
        eval_batches=lambda: iter([np.asarray(e) for e in evals]),
        on_log=lambda n, v: None)
    return port, ref


@pytest.mark.parametrize("cfg_kw", [
    dict(log_every=2, eval_every=3, eval_steps=2),
    dict(log_every=0, eval_every=2, eval_steps=10),
    dict(log_every=1, eval_every=0)])
def test_eval_entries_match_reference(cfg_kw):
    port, ref = _run_both(cfg_kw)
    evals = lambda h: [e for e in h if any(k.startswith("eval_") for k in e)]
    assert evals(port) == evals(ref)
    assert [e["step"] for e in port] == [e["step"] for e in ref]
    for p, r in zip(port, ref):
        if "loss" in r:
            assert p["loss"] == r["loss"]


def test_eval_means_over_eval_steps():
    _, hist = loop.train_loop(
        3, lambda s, b: (s, {"loss": torch.tensor(0.0)}), [0] * 4,
        loop.LoopConfig(total_steps=2, log_every=0, eval_every=2,
                        eval_steps=3),
        eval_fn=lambda s, b: {"m": float(b) + s},
        eval_batches=lambda: iter([1.0, 2.0, 6.0, 100.0]))
    assert hist == [{"step": 2, "eval_m": 3.0 + 3}]


@pytest.mark.parametrize("batch,want", [
    (np.zeros((4, 32), np.int32), 128),
    ((np.zeros((2, 16), np.int32), np.zeros((2, 16), np.int32)), 32),
    ((np.zeros((2, 8, 8, 3), np.float32), np.zeros(2, np.int32)), None),
    (np.zeros((4, 32), np.float32), None),
    ((), None), ("text", None)])
def test_tokens_in_batch_matches_reference(batch, want):
    assert jax_loop._tokens_in_batch(batch) == want
    as_torch = (tuple(torch.from_numpy(b) for b in batch)
                if isinstance(batch, tuple) else
                torch.from_numpy(batch) if isinstance(batch, np.ndarray)
                else batch)
    assert loop._tokens_in_batch(as_torch) == want
    assert loop._tokens_in_batch(batch) == want


def test_image_batches_leave_tokens_per_sec_unset():
    imgs = [(torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.int32))] * 2
    _, hist = loop.train_loop(
        0, lambda s, b: (s, {"loss": torch.tensor(1.0)}), imgs,
        loop.LoopConfig(total_steps=2, log_every=1), on_log=lambda n, v: None)
    assert all("tokens_per_sec" not in h for h in hist)
    tokens = [torch.zeros(2, 8, dtype=torch.int32)] * 2
    _, hist = loop.train_loop(
        0, lambda s, b: (s, {"loss": torch.tensor(1.0)}), tokens,
        loop.LoopConfig(total_steps=2, log_every=1), on_log=lambda n, v: None)
    assert all(h["tokens_per_sec"] > 0 for h in hist)


@pytest.fixture
def slow_threshold(monkeypatch):
    monkeypatch.setattr(ctel, "TRAIN_SLOW_STEP_SECONDS", 0.2)
    monkeypatch.delenv(loop.ENV_SLOW_STEP_PROFILE_DIR, raising=False)
    return 0.2


def _sleepy_step(slow_steps):
    def step(state, batch):
        if state + 1 in slow_steps:
            time.sleep(0.3)
        return state + 1, {"loss": torch.ones(2, 2).sum()}
    return step


def test_step_spans_and_slow_step_dump(slow_threshold, caplog):
    counter = ctel.train_slow_steps_total._only()
    before = counter.value
    with caplog.at_level(logging.WARNING,
                         logger="kubeflow_tpu_torch.train.trace"):
        loop.train_loop(0, _sleepy_step({2}), [1] * 3,
                        loop.LoopConfig(total_steps=3, log_every=3),
                        on_log=lambda n, v: None)
    assert counter.value - before == 1
    traces = ctel.train_tracer.recent(3)
    assert [t["request"] for t in traces] == ["1", "2", "3"]
    for t in traces:
        assert [s["name"] for s in t["spans"]] == ["data", "dispatch",
                                                    "bookkeeping"]
        assert t["result"] == "ok"
    assert traces[0]["spans"][1]["phase"] == "first"
    assert traces[1]["spans"][1]["phase"] == "run"
    assert traces[1]["spans"][1]["duration_ms"] >= 300
    dumps = [r for r in caplog.records
             if r.getMessage().startswith("slow train step trace")]
    assert len(dumps) == 1 and '"request": "2"' in dumps[0].getMessage()
    # No profile dir: no profile span anywhere.
    assert all(s["name"] != "profile" for t in traces for s in t["spans"])


def test_the_step_after_a_slow_one_is_profiled_once(slow_threshold,
                                                   tmp_path, monkeypatch):
    """Steps 2 and 4 are slow: step 3 is profiled (into the env's
    directory), step 5 is not (once a run); every slow step counts.  The
    profiler's first start in a process takes seconds, so it is started
    once beforehand; the count is held to the steps whose data + dispatch
    crossed the threshold."""
    with profiling.profile_trace(str(tmp_path / "warm-up")):
        pass
    logdir = str(tmp_path / "prof")
    monkeypatch.setenv(loop.ENV_SLOW_STEP_PROFILE_DIR, logdir)
    counter = ctel.train_slow_steps_total._only()
    before = counter.value
    x = torch.randn(16, 16)

    def step(state, batch):
        out = _sleepy_step({2, 4})(state, batch)
        return out[0], {"loss": (x @ x).sum()}

    loop.train_loop(0, step, [1] * 5, loop.LoopConfig(total_steps=5,
                                                      log_every=5),
                    on_log=lambda n, v: None)
    traces = ctel.train_tracer.recent(5)
    host = [sum(s["duration_ms"] for s in t["spans"]
                if s["name"] in ("data", "dispatch")) for t in traces]
    slow = [t["request"] for t, ms in zip(traces, host) if ms >= 200]
    assert {"2", "4"} <= set(slow)
    assert counter.value - before == len(slow)
    profiled = [t["request"] for t in traces
                if any(s["name"] == "profile" for s in t["spans"])]
    assert profiled == ["3"]
    files = os.listdir(logdir)
    assert sum(f.endswith(profiling.TRACE_SUFFIX) for f in files) == 1
    summary = profiling.trace_summary(logdir, cpu_events=True)
    assert summary["source"] == "cpu" and summary["kernels"] > 0


def test_a_profiler_failure_does_not_stop_the_step(slow_threshold, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv(loop.ENV_SLOW_STEP_PROFILE_DIR, str(tmp_path))

    def broken(logdir):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(profiling, "start_trace", broken)
    state, _ = loop.train_loop(0, _sleepy_step({1}), [1] * 3,
                               loop.LoopConfig(total_steps=3, log_every=0))
    assert state == 3


def test_trace_disabled_records_no_spans(monkeypatch):
    monkeypatch.setattr(ctel, "STEP_TRACE_ENABLED", False)
    n = len(ctel.train_tracer.recent())
    state, _ = loop.train_loop(0, _count_step,
                               [torch.ones(1)] * 2,
                               loop.LoopConfig(total_steps=2, log_every=0))
    assert state == 2 and len(ctel.train_tracer.recent()) == n


# -- train/profiling.py -----------------------------------------------------


def _resnet_step():
    model = create_model("resnet_tiny", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    state = steps.TrainState(model, steps.sgd(model.parameters(), 0.1))
    rs = np.random.RandomState(0)
    batch = (torch.from_numpy(rs.randn(2, 16, 16, 3).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, 2).astype(np.int32)))
    return state, steps.make_classification_train_step(
        has_batch_stats=True), batch


def test_profile_steps_and_trace_summary_on_the_cpu(tmp_path):
    state, step, batch = _resnet_step()
    (state, metrics), logdir = profiling.profile_steps(
        str(tmp_path), step, state, batch, warmup=1, steps=2)
    assert logdir == str(tmp_path) and state.step == 3
    assert torch.isfinite(metrics["loss"])
    # A CPU trace has no device kernels: refused by default.
    with pytest.raises(ValueError, match="no device kernels"):
        profiling.trace_summary(logdir)
    summary = profiling.trace_summary(logdir, cpu_events=True)
    assert summary["source"] == "cpu"
    assert summary["classes"]["conv"]["ms"] > 0
    assert set(summary["classes"]) == set(profiling.CLASSES)
    assert summary["total_ms"] == pytest.approx(
        sum(c["ms"] for c in summary["classes"].values()))
    # with_flops counts the forward convolutions and matrix products.
    assert summary["flops"] > 0 and summary["tflops_per_s"] > 0


def test_trace_summary_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.trace_summary(str(tmp_path))


def test_profile_trace_writes_on_a_crash_and_reraises(tmp_path):
    with pytest.raises(KeyError, match="boom"):
        with profiling.profile_trace(str(tmp_path)):
            torch.ones(4) @ torch.ones(4)
            raise KeyError("boom")
    assert any(f.endswith(profiling.TRACE_SUFFIX)
               for f in os.listdir(tmp_path))


@pytest.mark.parametrize("name,cls", [
    ("flash_fwd_kernel<64>", "flash"), ("flash_bwd_dkv_kernel", "flash"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("nvjet_tst_128x256", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "elementwise"),
    ("some_kernel", "other")])
def test_kernel_classes(name, cls):
    assert profiling.kernel_class(name) == cls
