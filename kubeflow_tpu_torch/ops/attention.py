"""Multi-head attention over the port's CUDA flash kernels, BSHD layout.

All shapes are ``[batch, seq, heads, head_dim]``; GQA passes k/v with
fewer heads.  ``impl`` routes every call: "auto" runs the kernel on CUDA
tensors and the plain version on CPU tensors, "kernel" requires CUDA
tensors, "plain" always runs ``plain_attention`` (the counterpart of
``xla_attention`` in ``kubeflow_tpu/ops/attention.py``).  The routing never changes
a result beyond the kernels' rounding: the CPU parity tests pin the plain
path to the JAX reference, and ``chip_smoke.py`` each kernel to it.

``dot_product_attention`` counts each call by the route it takes in
``attention_kernel_calls_total{impl="kernel"|"plain"|"ring"|"ulysses"}``
(``telemetry/compute.py``; a ring or Ulysses call counts once under its
own label, not again for the blocks it runs), and before a plain call
publishes its
``attention_footprint_bytes`` (the pre-flight, with the budget warning).
The reference estimates only its masked (causal or segmented) XLA calls;
the port estimates every plain call, since each materializes the same f32
logits and probabilities whatever carries its mask (T5's calls carry it
in the bias).  ``decode_attention`` is not counted, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops.cuda import flash_attention as _k2
from kubeflow_tpu_torch.ops.cuda import flash_decode as _k5
from kubeflow_tpu_torch.ops.cuda.flash_attention import plain_attention
from kubeflow_tpu_torch.ops.cuda.flash_decode import plain_decode
from kubeflow_tpu_torch.telemetry import compute as ctel

IMPLS = ("auto", "kernel", "plain")
SEQUENCE_PARALLEL = ("ring", "ulysses")

__all__ = ["attention_footprint_bytes", "decode_attention",
           "dot_product_attention", "plain_attention", "plain_decode"]


def attention_footprint_bytes(*, batch: int, heads: int, q_len: int,
                              k_len: int, causal: bool,
                              segments: bool) -> int:
    """The bytes a plain attention call materializes, from shapes alone:
    its f32 logits and softmax probabilities, [b, h, sq, sk] each (the
    reference's formula, ``kubeflow_tpu/ops/attention.py:29-48``; the masks
    add no buffer of that size, so ``causal`` and ``segments`` only label
    the warning)."""
    del causal, segments
    return 2 * 4 * batch * heads * q_len * k_len


def _preflight(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
               segments: bool) -> None:
    b, sq, h = q.shape[:3]
    sk = k.shape[1]
    est = attention_footprint_bytes(batch=b, heads=h, q_len=sq, k_len=sk,
                                    causal=causal, segments=segments)
    ctel.note_attention_estimate(est, batch=b, heads=h, q_len=sq, k_len=sk,
                                 causal=causal, segments=segments,
                                 impl="plain")


def _route(impl: str, t: torch.Tensor) -> bool:
    """True to take the plain version: ``impl="plain"``, or a CPU tensor
    under "auto"."""
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
    (K2-lse forward, K3 + K4 backward); any other runs K2 alone.

    ``impl="ring"`` or ``"ulysses"``: q, k and v are this rank's chunk of
    the sequence over the active mesh's ``sp`` axis (``parallel/context.py``
    ``global_mesh``; RuntimeError without one), attended exactly over the
    whole sequence by ``parallel/ring.py`` or ``parallel/ulysses.py``; they
    take no ``bias`` or ``segment_ids`` (NotImplementedError)."""
    if impl in SEQUENCE_PARALLEL:
        return _sequence_parallel(q, k, v, impl, causal=causal,
                                  segment_ids=segment_ids, bias=bias,
                                  softmax_scale=softmax_scale)
    if _route(impl, q):
        ctel.note_attention_impl("plain")
        _preflight(q, k, causal=causal, segments=segment_ids is not None)
        return plain_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, bias=bias,
                               softmax_scale=softmax_scale)
    if bias is not None:
        raise ValueError("the flash kernel takes no additive bias; pass "
                         "impl='plain' for a biased call on the card")
    ctel.note_attention_impl("kernel")
    return flash(q, k, v, causal=causal, segment_ids=segment_ids,
                 softmax_scale=softmax_scale)


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = False, segment_ids: Optional[torch.Tensor] = None,
          softmax_scale: Optional[float] = None) -> torch.Tensor:
    """The flash kernels on CUDA tensors, the plain version on CPU ones,
    uncounted: K2-lse with K3 + K4 when autograd records the call, else
    K2.  ``dot_product_attention``'s kernel route, and the local attention
    of a Ulysses head group."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _k2.flash_attention_with_lse(
            q, k, v, causal=causal, segment_ids=segment_ids,
            softmax_scale=softmax_scale)[0]
    return _k2.flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               softmax_scale=softmax_scale)


def _sequence_parallel(q, k, v, impl, *, causal, segment_ids, bias,
                       softmax_scale):
    from kubeflow_tpu_torch.parallel.context import get_global_mesh

    mesh = get_global_mesh()
    if mesh is None:
        raise RuntimeError(
            f"impl={impl!r} needs an active mesh; wrap the call in "
            "kubeflow_tpu_torch.parallel.context.global_mesh(mesh)")
    if bias is not None or segment_ids is not None:
        raise NotImplementedError(f"{impl} attention: bias/segment_ids TODO")
    ctel.note_attention_impl(impl)
    if impl == "ring":
        from kubeflow_tpu_torch.parallel.ring import ring_attention

        return ring_attention(q, k, v, mesh=mesh, causal=causal,
                              softmax_scale=softmax_scale)
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    return ulysses_attention(q, k, v, mesh=mesh, causal=causal,
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
