"""RMSNorm: the plain PyTorch version and the wrapper of the CUDA kernel
``ops/csrc/rms_norm.cu`` (replaces ``kubeflow_tpu/ops/pallas/rms_norm.py``).

``rms_norm`` launches the kernel for a CUDA tensor and raises on what the
kernel does not take; it takes the plain version only for a CPU tensor.
``rms_norm.launches`` counts kernel launches.  ``RMSNormFunction`` makes
it differentiable: the kernel forward and the reference's analytic
backward in plain PyTorch (``rms_norm_backward``; the reference has no
backward kernel, ``kubeflow_tpu/ops/pallas/rms_norm.py`` ``_bwd``).
"""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build


def plain_rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` with f32 accumulation,
    output in ``x.dtype`` (the reference formula, ``ops/norms.py``)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  CUDA: the kernel (x bf16 or f32,
    contiguous, last dim a multiple of 8; scale f32 of that length)."""
    if x.device.type == "cpu":
        return plain_rms_norm(x, scale, eps=eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(
            f"rms_norm kernel: x on {x.device}, scale on {scale.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rms_norm kernel takes bf16 or f32 x, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(
            f"rms_norm kernel takes an f32 scale of shape ({d},), got "
            f"{scale.dtype} {tuple(scale.shape)}")
    if d % 8 or not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(
            f"rms_norm kernel needs contiguous x and scale and a last dim "
            f"that is a multiple of 8, got {tuple(x.shape)}")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned tensors")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    err = _build.library().kft_rms_norm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check("kft_rms_norm", err)
    rms_norm.launches += 1
    return y


rms_norm.launches = 0


def rms_norm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      *, eps: float = 1e-6):
    """``(dx, dscale)`` of ``rms_norm`` for the cotangent ``g``: the
    reference's formula in f32, dx = r * g * scale - x * r^3 *
    mean(g * scale * x), dscale = sum over rows of g * x * r, with
    r = rsqrt(mean(x^2) + eps); dx in x's dtype, dscale in scale's."""
    d = x.shape[-1]
    x32, g32, s32 = x.float(), g.float(), scale.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gs = g32 * s32
    dx = r * gs - x32 * r.pow(3) * (gs * x32).mean(dim=-1, keepdim=True)
    dscale = (g32 * x32 * r).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNormFunction(torch.autograd.Function):
    """Differentiable ``rms_norm`` on the card: the kernel forward (one
    launch) and ``rms_norm_backward``.  Saves x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, g, eps=ctx.eps)
        return dx, dscale, None
