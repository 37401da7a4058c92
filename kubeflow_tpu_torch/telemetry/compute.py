"""Train-step telemetry of the port: model FLOPs accounting, MFU against
the H100's peak, and the step histogram and throughput gauges.

The port's copy of the accounting in ``kubeflow_tpu/telemetry/compute.py``
(``lm_train_flops_per_token``, the same formula, so MFU reads the same
way in both packages), on the port's standard-library registry
(``telemetry/metrics.py``).  The MFU denominator is the NVIDIA H100 SXM
dense bf16 tensor-core peak, 989 TFLOP/s (NVIDIA's data sheet, at the
700 W power limit), not the TPU constant of the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

from kubeflow_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
)

# NVIDIA H100 SXM, dense bf16 on the tensor cores (no sparsity).
H100_SXM_BF16_PEAK_TFS = 989.0

registry = Registry()

_STEP_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0, 180.0, 600.0)

train_step_seconds = Histogram(
    "train_step_seconds",
    "Optimizer-step wall time by phase (first = the first step of a loop, "
    "which pays the kernel build and the allocator's warm-up; run = steady "
    "state)", ["phase"], registry=registry, buckets=_STEP_BUCKETS)
train_steps_total = Counter(
    "train_steps_total", "Optimizer steps executed", registry=registry)
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
