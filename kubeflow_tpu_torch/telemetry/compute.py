"""Compute telemetry of the port: model FLOPs accounting, MFU against the
H100's peak, the step histogram and throughput gauges, the step traces
(data -> dispatch -> bookkeeping spans) with the slow-step threshold and
counter, step quantiles, device memory, and the attention route counters
with the plain route's footprint pre-flight.

The port's copy of ``kubeflow_tpu/telemetry/compute.py``, on the port's
standard-library registry (``telemetry/metrics.py``):

* **Accounting.** ``lm_train_flops_per_token`` is the reference's formula,
  so MFU reads the same way in both packages.  The MFU denominator is the
  NVIDIA H100 SXM dense bf16 tensor-core peak, 989 TFLOP/s (NVIDIA's data
  sheet, at the 700 W power limit), not the TPU constant of the reference.
* **Step quantiles.** ``observe_window`` books a timed n-step window as n
  observations of its mean; ``step_quantiles`` interpolates the
  histogram (``since=`` a ``step_snapshot`` diffs out earlier work);
  ``train_step_seconds_p50``/``_p99`` are computed at scrape time over
  the run phase.
* **Device memory.** ``device_memory_bytes{device,kind}`` is computed at
  scrape time from PyTorch's caching allocator, one ``cuda:N`` label per
  card: ``in_use`` is ``allocated_bytes.all.current`` and ``peak`` is
  ``allocated_bytes.all.peak`` of ``torch.cuda.memory_stats``
  (``peak`` is what ``torch.cuda.max_memory_allocated`` reads), and
  ``limit`` is the card's total memory,
  ``torch.cuda.get_device_properties(N).total_memory`` (the total that
  ``torch.cuda.mem_get_info`` also returns, read from the cached device
  properties).
  Where CUDA is not initialised (the CPU) the family has no samples and
  ``hbm_peak_bytes``/``free_hbm_bytes`` return None, as the reference's
  do on its CPU backend.
* **Attention.** ``attention_kernel_calls_total{impl}`` counts
  ``ops.dot_product_attention`` calls by route, ``kernel`` or ``plain``,
  once a call (the port runs eagerly; the reference counts once a jit
  trace, ``pallas`` or ``xla``).  ``note_attention_estimate`` publishes a
  plain call's f32 logits-and-probabilities footprint before the call
  allocates it, and warns once (a JSON line, a counter) when it exceeds
  ``ATTENTION_HBM_BUDGET_FRACTION`` of the free device memory.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Dict, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    ScrapeGauge,
    histogram_quantiles,
    histogram_snapshot,
)
from kubeflow_tpu_torch.telemetry.trace import Tracer

log = logging.getLogger("kubeflow_tpu_torch.telemetry.compute")

# NVIDIA H100 SXM, dense bf16 on the tensor cores (no sparsity).
H100_SXM_BF16_PEAK_TFS = 989.0

registry = Registry()

# A step whose data + dispatch wall time reaches this dumps its span tree
# as one JSON log line (kubeflow_tpu_torch.train.trace logger) and counts
# in train_slow_steps_total.  Env-tunable; tests set the attribute.
TRAIN_SLOW_STEP_SECONDS = config.env_float("TRAIN_SLOW_STEP_SECONDS", 10.0)
# Step tracing is on unless TRAIN_TRACE_DISABLE is set: a span costs
# microseconds against steps of milliseconds to seconds.
STEP_TRACE_ENABLED = not config.env_bool("TRAIN_TRACE_DISABLE", False)
# Warn when one plain attention call's footprint estimate exceeds this
# fraction of the free device memory.
ATTENTION_HBM_BUDGET_FRACTION = config.env_float(
    "ATTENTION_HBM_BUDGET_FRACTION", 0.5)

# One trace a step (data -> dispatch -> bookkeeping spans).
train_tracer = Tracer(
    "train", buffer_size=config.env_int("TRAIN_TRACE_BUFFER_SIZE", 64),
    logger="kubeflow_tpu_torch.train.trace",
    slow_message="slow train step trace")

_STEP_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0, 180.0, 600.0)

train_step_seconds = Histogram(
    "train_step_seconds",
    "Optimizer-step wall time by phase (first = the first step of a loop, "
    "which pays the kernel build and the allocator's warm-up; run = steady "
    "state)", ["phase"], registry=registry, buckets=_STEP_BUCKETS)
train_steps_total = Counter(
    "train_steps_total", "Optimizer steps executed", registry=registry)
train_slow_steps_total = Counter(
    "train_slow_steps_total",
    "Steps that crossed TRAIN_SLOW_STEP_SECONDS (their span tree was "
    "dumped; see the kubeflow_tpu_torch.train.trace logger)",
    registry=registry)
train_tokens_per_sec = Gauge(
    "train_tokens_per_sec",
    "Training throughput over the last completed log window",
    registry=registry)
train_model_tflops_per_sec = Gauge(
    "train_model_tflops_per_sec",
    "Useful model TFLOP/s over the last log window (tokens/s x model "
    "FLOPs/token; remat recompute not counted)", registry=registry)
train_mfu = Gauge(
    "train_mfu",
    "Model FLOPs utilization over the last log window against the H100 "
    "SXM dense bf16 peak (989 TFLOP/s)",
    registry=registry)

attention_mask_bytes_estimate = Gauge(
    "attention_mask_bytes_estimate",
    "Pre-flight estimate of the bytes the plain attention route "
    "materializes for its last call (f32 logits + probabilities, "
    "[b, h, sq, sk] each), computed from shapes before the call allocates "
    "them", registry=registry)
attention_kernel_calls_total = Counter(
    "attention_kernel_calls_total",
    "dot_product_attention calls by the route actually taken (kernel = "
    "the CUDA flash kernels, plain = the plain PyTorch attention), one "
    "count a call", ["impl"], registry=registry)
attention_mask_budget_warnings_total = Counter(
    "attention_mask_budget_warnings_total",
    "Attention calls whose footprint estimate exceeded "
    "ATTENTION_HBM_BUDGET_FRACTION of free device memory (one structured "
    "warning line each)", registry=registry)


def lm_train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per token of one LM train step (forward + backward =
    3 x forward): matmuls at 2*M*N*K, causal attention at half the s^2
    work, the head included; embedding, norms, rotary and elementwise
    ops left out; remat recompute not counted (the reference's
    accounting, ``kubeflow_tpu/telemetry/compute.py:138-159``)."""
    d = cfg.dim
    kv_dim = d * cfg.n_kv_heads // cfg.n_heads
    proj = 2 * d * d + 2 * 2 * d * kv_dim + 2 * d * d  # q, k+v, o
    attn = 2 * 2 * seq * d / 2  # QK^T + AV at causal half-occupancy
    ffn = 3 * 2 * d * cfg.ffn_dim  # SwiGLU: gate, up, down
    head = 2 * d * cfg.vocab_size
    return 3.0 * (cfg.n_layers * (proj + attn + ffn) + head)


def model_tflops_per_sec(tokens_per_sec: float,
                         flops_per_token: float) -> float:
    return tokens_per_sec * flops_per_token / 1e12


def mfu(tokens_per_sec: float, flops_per_token: float) -> float:
    return (model_tflops_per_sec(tokens_per_sec, flops_per_token)
            / H100_SXM_BF16_PEAK_TFS)


def update_throughput(tokens_per_sec: float, *,
                      flops_per_token: Optional[float] = None
                      ) -> Dict[str, float]:
    """Set the throughput gauges from one completed window and return the
    values for the log line; without a FLOPs count only tokens/s."""
    train_tokens_per_sec.set(tokens_per_sec)
    out: Dict[str, float] = {"tokens_per_sec": tokens_per_sec}
    if flops_per_token:
        tfs = model_tflops_per_sec(tokens_per_sec, flops_per_token)
        train_model_tflops_per_sec.set(tfs)
        train_mfu.set(tfs / H100_SXM_BF16_PEAK_TFS)
        out["model_tflops_per_sec"] = tfs
        out["mfu"] = tfs / H100_SXM_BF16_PEAK_TFS
    return out


def observe_step(seconds: float, *, phase: str = "run") -> None:
    """One optimizer step's wall time into the step histogram."""
    train_step_seconds.labels(phase=phase).observe(seconds)
    train_steps_total.inc()


def observe_window(n_steps: int, window_seconds: float, *,
                   phase: str = "run") -> None:
    """A timed n-step window, booked as n observations of its mean step
    time, so window timing and the per-step histogram stay one
    distribution."""
    if n_steps <= 0:
        return
    mean = window_seconds / n_steps
    child = train_step_seconds.labels(phase=phase)
    for _ in range(n_steps):
        child.observe(mean)
    train_steps_total.inc(n_steps)


def step_snapshot() -> Dict[float, float]:
    """Cumulative step-histogram buckets, summed over phases: pass to
    ``step_quantiles(since=...)`` to diff out earlier work."""
    return histogram_snapshot(train_step_seconds, {})


def step_quantiles(qs=(0.5, 0.99), *,
                   since: Optional[Dict[float, float]] = None,
                   phase: Optional[str] = None):
    """Estimated step-time quantiles, summed over phases unless ``phase``
    narrows them."""
    match = {} if phase is None else {"phase": phase}
    return histogram_quantiles(train_step_seconds, match, qs, since=since)


def _step_quantile_gauge(q: float) -> ScrapeGauge:
    def collect():
        value = step_quantiles((q,), phase="run")[q]
        return [] if value is None else [((), value)]

    return ScrapeGauge(
        f"train_step_seconds_p{int(q * 100)}",
        f"Estimated p{int(q * 100)} run-phase step time (histogram "
        "interpolation)", collect, registry=registry)


_step_quantile_gauge(0.5)
_step_quantile_gauge(0.99)


def device_memory_snapshot() -> Dict[str, Dict[str, int]]:
    """{"cuda:N": {"in_use", "peak", "limit": bytes}} for every card, from
    the caching allocator's statistics (see the module docstring); empty
    where CUDA is not initialised."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        alloc = torch.cuda.memory_stats_as_nested_dict(i).get(
            "allocated_bytes", {}).get("all", {})
        out[f"cuda:{i}"] = {
            "in_use": int(alloc.get("current", 0)),
            "peak": int(alloc.get("peak", 0)),
            "limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def _memory_samples():
    return [((dev, kind), val)
            for dev, kinds in sorted(device_memory_snapshot().items())
            for kind, val in sorted(kinds.items())]


ScrapeGauge(
    "device_memory_bytes",
    "Device memory by device and kind (in_use | peak | limit), from the "
    "CUDA caching allocator's statistics and the card's total memory; "
    "absent where CUDA is not initialised", _memory_samples,
    labelnames=("device", "kind"), registry=registry)


def hbm_peak_bytes() -> Optional[int]:
    """The largest peak across cards; None when no card reports one."""
    peaks = [k["peak"] for k in device_memory_snapshot().values()
             if "peak" in k]
    return max(peaks) if peaks else None


def free_hbm_bytes() -> Optional[int]:
    """The tightest limit - in_use across cards, the budget of the
    attention pre-flight; None when no card reports both (the CPU): the
    estimate is then published without the budget check."""
    frees = [k["limit"] - k["in_use"]
             for k in device_memory_snapshot().values()
             if "limit" in k and "in_use" in k]
    return min(frees) if frees else None


def note_attention_estimate(estimate_bytes: int, **shape_attrs) -> bool:
    """Publish an attention footprint estimate (the gauge) and, when it
    exceeds the budget fraction of free device memory, count it and log
    one structured JSON warning line.  True when the warning fired."""
    attention_mask_bytes_estimate.set(estimate_bytes)
    free = free_hbm_bytes()
    if free is None:
        return False
    budget = ATTENTION_HBM_BUDGET_FRACTION * free
    if estimate_bytes <= budget:
        return False
    attention_mask_budget_warnings_total.inc()
    log.warning(
        "attention footprint over budget: %s",
        json.dumps({
            "event": "attention_mask_budget_exceeded",
            "estimate_bytes": int(estimate_bytes),
            "free_hbm_bytes": int(free),
            "budget_fraction": ATTENTION_HBM_BUDGET_FRACTION,
            "ts": round(time.time(), 3),
            **shape_attrs,
        }, sort_keys=True))
    return True


def attention_estimate_value() -> float:
    """The estimate gauge's value (0.0 before any plain call)."""
    return attention_mask_bytes_estimate.sample()


def note_attention_impl(impl: str) -> None:
    """Count one dot_product_attention call on route ``impl``."""
    attention_kernel_calls_total.labels(impl=impl).inc()


def attention_impl_calls(impl: str) -> float:
    """Cumulative attention_kernel_calls_total{impl} (0.0 before any
    call)."""
    return attention_kernel_calls_total.sample(impl=impl) or 0.0


def render() -> str:
    return registry.render()
