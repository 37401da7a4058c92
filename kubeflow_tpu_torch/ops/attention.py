"""Multi-head attention over the port's CUDA flash kernels, BSHD layout.

All shapes are ``[batch, seq, heads, head_dim]``; GQA passes k/v with
fewer heads.  ``impl`` routes every call: "auto" runs the kernel on CUDA
tensors and the plain version on CPU tensors, "kernel" requires CUDA
tensors, "plain" always runs ``plain_attention`` (the counterpart of
``xla_attention`` in ``kubeflow_tpu/ops/attention.py``).  The routing never changes
a result beyond the kernels' rounding: the CPU parity tests pin the plain
path to the JAX reference, and ``chip_smoke.py`` each kernel to it.
"""
from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops.cuda import flash_attention as _k2
from kubeflow_tpu_torch.ops.cuda import flash_decode as _k5
from kubeflow_tpu_torch.ops.cuda.flash_attention import plain_attention
from kubeflow_tpu_torch.ops.cuda.flash_decode import plain_decode

IMPLS = ("auto", "kernel", "plain")
NOT_PORTED = ("ring", "ulysses")

__all__ = ["decode_attention", "dot_product_attention", "plain_attention",
           "plain_decode"]


def _route(impl: str, t: torch.Tensor) -> bool:
    """True to take the plain version: ``impl="plain"``, or a CPU tensor
    under "auto"."""
    if impl in NOT_PORTED:
        raise NotImplementedError(
            f"impl={impl!r} (sequence parallelism) is not ported yet; see "
            "ROADMAP.md")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel" and t.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs CUDA tensors, got {t.device}")
    return impl == "plain" or t.device.type == "cpu"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          segment_ids: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention, BSHD.  The flash kernel takes no
    additive ``bias``: a biased call on CUDA tensors raises unless
    ``impl="plain"``.  On CUDA tensors, a call that autograd records (grad
    enabled and q, k or v requiring grad) runs the differentiable kernels
    (K2-lse forward, K3 + K4 backward); any other runs K2 alone."""
    if _route(impl, q):
        return plain_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, bias=bias,
                               softmax_scale=softmax_scale)
    if bias is not None:
        raise ValueError("the flash kernel takes no additive bias; pass "
                         "impl='plain' for a biased call on the card")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _k2.flash_attention_with_lse(
            q, k, v, causal=causal, segment_ids=segment_ids,
            softmax_scale=softmax_scale)[0]
    return _k2.flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               softmax_scale=softmax_scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_rows: torch.Tensor, *,
                     softmax_scale: Optional[float] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Single-token attention, q [b, 1, h, d] over a sequence-major cache
    k/v [b, S, kv_h, d] with one head-uniform bias row [b, S] f32."""
    if _route(impl, q):
        return plain_decode(q, k, v, bias_rows, softmax_scale=softmax_scale)
    return _k5.flash_decode(q, k, v, bias_rows, softmax_scale=softmax_scale)
