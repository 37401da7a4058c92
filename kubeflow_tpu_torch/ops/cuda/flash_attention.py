"""Attention: the plain PyTorch version and the wrapper of the CUDA flash
forward kernel ``ops/csrc/flash_attention_fwd.cu`` (replaces
``kubeflow_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``).

``flash_attention`` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it takes ``plain_attention`` only for CPU
tensors.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_h, d] -> [b, s, kv_h * n_rep, d]; kv head j serves q heads
    j * n_rep .. j * n_rep + n_rep - 1."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention, BSHD, GQA by repeating kv heads: f32
    logits, then the scale, then the additive bias; end-aligned causal
    (row + sk - sq >= col); ``segment_ids`` equality; masked logits filled
    with -1e30 (not -inf: a fully masked row is uniform, not NaN).  The
    counterpart of ``xla_attention`` in ``kubeflow_tpu/ops/attention.py``."""
    orig_dtype = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    cond = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        cond = (rows + (sk - sq)) >= cols
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        cond = seg if cond is None else cond & seg
    if cond is not None:
        logits = logits.masked_fill(~cond, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(orig_dtype)


def check_supported(q, k, v, *, causal, segment_ids) -> None:
    """Raise ``ValueError`` on a call the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not BSHD with equal k/v")
    b, sq, hq, d = q.shape
    bk, sk, hk, dk = k.shape
    if bk != b or dk != d or hq % hk:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not match k "
            f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if causal and sq > sk:
        raise ValueError(
            f"flash_attention: causal needs sq <= sk, got {sq} > {sk}")
    if segment_ids is not None:
        if sq != sk or tuple(segment_ids.shape) != (b, sq):
            raise ValueError(
                f"flash_attention: segment_ids {tuple(segment_ids.shape)} "
                f"need sq == sk and shape ({b}, {sq})")
        if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
            raise ValueError("flash_attention: segment_ids must be integers")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel takes bf16, {name} is "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward, BSHD, GQA via fewer kv heads, any sq/sk.
    CUDA: the kernel (bf16, head_dim 64 or 128, contiguous)."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               softmax_scale=softmax_scale)
    check_supported(q, k, v, causal=causal, segment_ids=segment_ids)
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    seg_ptr = None
    if segment_ids is not None:
        if segment_ids.device != q.device:
            raise ValueError(
                f"flash_attention: segment_ids on {segment_ids.device}")
        segment_ids = segment_ids.to(torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    o = torch.empty_like(q)
    err = _build.library().kft_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
        b, sq, sk, hq, hk, d, int(causal), float(scale),
        _build.stream_handle(q.device))
    _build.check("kft_flash_attention_fwd", err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
