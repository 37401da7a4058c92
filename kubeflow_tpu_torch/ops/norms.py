"""Normalization ops.  RMSNorm is the hot one (every Llama layer, twice)."""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.cuda import rms_norm as _k1
from kubeflow_tpu_torch.ops.cuda.rms_norm import plain_rms_norm

IMPLS = ("auto", "kernel", "plain")

__all__ = ["IMPLS", "plain_rms_norm", "rms_norm"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             impl: str = "auto") -> torch.Tensor:
    """RMSNorm with f32 accumulation, output in ``x.dtype``.

    impl: "auto" runs the CUDA kernel on a CUDA tensor and the plain
    version on a CPU tensor; "kernel" requires a CUDA tensor (raises on
    the CPU); "plain" always runs the plain PyTorch version.  Every route
    is differentiable: the kernel's through ``RMSNormFunction`` (the
    reference's analytic backward as a kernel), the plain one by torch
    autograd.  The scale may be f32 or bf16; it is cast to f32 inside."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {x.device}")
    if impl == "plain" or x.device.type == "cpu":
        return plain_rms_norm(x, scale, eps=eps)
    return _k1.RMSNormFunction.apply(x, scale, eps)
