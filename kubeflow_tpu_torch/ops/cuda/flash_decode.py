"""Single-token decode attention: the plain PyTorch version and the
wrapper of the CUDA kernel ``ops/csrc/flash_decode.cu`` (replaces
``kubeflow_tpu/ops/pallas/flash_decode.py`` ``_decode_kernel``).

``flash_decode`` launches the kernel (one launch: a thread block cluster
per kv head and row, merged in shared memory, so the only allocation is
the output) for CUDA tensors and raises on what the kernel does not take;
it takes ``plain_decode`` only for CPU tensors.  ``flash_decode.launches``
counts calls that launched the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.cuda.flash_attention import HEAD_DIMS, plain_attention

GROUP_SIZES = (1, 2, 4, 8)


def plain_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias_rows: torch.Tensor, *,
                 softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [b, 1, h, d] over a sequence-major cache k/v [b, S, kv_h, d] with
    one additive f32 bias row [b, S] shared by every head."""
    return plain_attention(q, k, v, bias=bias_rows[:, None, None, :],
                           softmax_scale=softmax_scale)


def check_supported(q, k, v, bias_rows) -> None:
    """Raise ``ValueError`` on a call the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not [b,1,h,d] / [b,S,kv_h,d]")
    b, s, h, d = q.shape
    bk, S, kv_h, dk = k.shape
    if s != 1 or bk != b or dk != d or h % kv_h:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k.shape)}")
    if d not in HEAD_DIMS or h // kv_h not in GROUP_SIZES:
        raise ValueError(
            f"flash_decode: head_dim {d} (takes {HEAD_DIMS}) or group "
            f"{h // kv_h} (takes {GROUP_SIZES}) not supported")
    if tuple(bias_rows.shape) != (b, S) or bias_rows.dtype != torch.float32:
        raise ValueError(
            f"flash_decode: bias_rows must be f32 [{b}, {S}], got "
            f"{bias_rows.dtype} {tuple(bias_rows.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias_rows", bias_rows)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}")
        if name != "bias_rows" and t.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode kernel takes bf16, {name} is "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             "16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias_rows: torch.Tensor, *,
                 softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention, q [b, 1, h, d] over k/v [b, S, kv_h, d] (any S),
    bias row [b, S] f32.  CUDA: the kernel (bf16, head_dim 64 or 128,
    h / kv_h in 1, 2, 4, 8)."""
    if q.device.type == "cpu":
        return plain_decode(q, k, v, bias_rows, softmax_scale=softmax_scale)
    check_supported(q, k, v, bias_rows)
    b, _, h, d = q.shape
    S, kv_h = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    o = torch.empty_like(q)
    err = _build.library().kft_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(),
        o.data_ptr(), b, S, h, kv_h, d, float(scale),
        _build.stream_handle(q.device))
    _build.check("kft_flash_decode", err)
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
