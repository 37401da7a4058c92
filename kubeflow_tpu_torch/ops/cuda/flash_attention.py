"""Attention: the plain PyTorch versions and the wrappers of the CUDA flash
kernels, forward ``ops/csrc/flash_attention_fwd.cu`` (replaces
``kubeflow_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``, with and
without its logsumexp output) and backward ``ops/csrc/flash_attention_bwd.cu``
(replaces ``_dq_kernel`` and ``_dkv_kernel`` of ``_flash_bwd``).

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; it takes its plain version only for CPU tensors.
Each counts its launches in ``<wrapper>.launches``:

* ``flash_attention``: K2, the forward without the lse (serving);
* ``flash_attention_fwd_lse``: K2-lse, the forward that also writes the
  per-row logsumexp [b, h, sq] f32 (the reference lane-replicates it as
  [b, h, sq, 128]);
* ``flash_attention_dq``: K3, dQ and delta = rowsum(dO * O) - g_lse;
* ``flash_attention_dkv``: K4, dK and dV, summed over each GQA group.

``flash_attention_with_lse`` is the differentiable op over K2-lse and
K3 + K4 (a ``torch.autograd.Function``), differentiable through both of
its outputs, as the reference's is.
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


def _masked_logits(q, k, *, causal, segment_ids, bias, scale):
    """f32 logits [b, h, sq, sk] (k already repeated to q's heads): the
    scale, then the additive bias, masked slots filled with -1e30; and the
    visibility mask (None when nothing is masked)."""
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
    return logits, cond


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
    logits, _ = _masked_logits(q, k, causal=causal, segment_ids=segment_ids,
                               bias=bias, scale=scale)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(orig_dtype)


def plain_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             segment_ids: Optional[torch.Tensor] = None,
                             softmax_scale: Optional[float] = None):
    """``(o, lse)``: ``plain_attention`` and the logsumexp of each row's
    masked, scaled logits, [b, h, sq] f32 (the reference's
    ``flash_attention_with_lse`` lse at lane 0).  Differentiable in both
    outputs by torch autograd."""
    orig_dtype = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    logits, _ = _masked_logits(q, k, causal=causal, segment_ids=segment_ids,
                               bias=None, scale=scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(orig_dtype), lse


def _group_sum(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kv_h * n_rep, d] -> [b, s, kv_h, d], summing each group (the
    adjoint of ``repeat_kv``)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x.reshape(b, s, h // n_rep, n_rep, d).sum(dim=3)


def _bwd_probs(q, k, lse, *, causal, segment_ids, scale):
    """P = exp(S * scale - lse), zero where masked, f32 [b, h, sq, sk]."""
    logits, cond = _masked_logits(q, k, causal=causal,
                                  segment_ids=segment_ids, bias=None,
                                  scale=scale)
    p = torch.exp(logits - lse.float()[..., None])
    return p if cond is None else p.masked_fill(~cond, 0.0)


def plain_attention_dq(q, k, v, o, do, lse, *, causal: bool = False,
                       segment_ids=None, softmax_scale=None, g_lse=None):
    """The plain version of K3: ``(dq, delta)`` from the forward's output
    and lse, the reference's ``_bwd_tile`` + ``_dq_kernel`` math in f32:
    P = exp(S * scale - lse), delta = rowsum(dO * O) - g_lse [b, h, sq],
    dS = P * (dO V^T - delta) * scale, dQ = dS K (in q's dtype)."""
    n_rep = q.shape[2] // k.shape[2]
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    p = _bwd_probs(q, kr, lse, causal=causal, segment_ids=segment_ids,
                   scale=scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float())
    return dq.to(q.dtype), delta.contiguous()


def plain_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        segment_ids=None, softmax_scale=None):
    """The plain version of K4: ``(dk, dv)`` from the lse and delta, the
    reference's ``_dkv_kernel`` math in f32 (dV = P^T dO, dK = dS^T Q),
    summed over the q heads of each kv head, in k's dtype."""
    n_rep = q.shape[2] // k.shape[2]
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    p = _bwd_probs(q, kr, lse, causal=causal, segment_ids=segment_ids,
                   scale=scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = p * (dp - delta.float()[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (_group_sum(dk, n_rep).to(k.dtype),
            _group_sum(dv, n_rep).to(v.dtype))


def plain_attention_bwd(q, k, v, do, *, causal: bool = False,
                        segment_ids=None, softmax_scale=None, g_lse=None):
    """``(dq, dk, dv)`` by torch autograd through
    ``plain_attention_with_lse``: the independent reference the kernels'
    backward is held against (in f32 when given f32 inputs)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, lse = plain_attention_with_lse(*leaves, causal=causal,
                                          segment_ids=segment_ids,
                                          softmax_scale=softmax_scale)
        outs, grads = [o], [do]
        if g_lse is not None:
            outs.append(lse)
            grads.append(g_lse)
        return torch.autograd.grad(outs, leaves, grads)


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


def _segments_arg(segment_ids, q):
    """(int32 contiguous ids or None, their pointer or None).  The caller
    holds the returned tensor until the launch, so a converted copy is
    not freed before its pointer is used."""
    if segment_ids is None:
        return None, None
    if segment_ids.device != q.device:
        raise ValueError(
            f"flash_attention: segment_ids on {segment_ids.device}")
    seg = segment_ids.to(torch.int32).contiguous()
    return seg, seg.data_ptr()


def _launch_fwd(q, k, v, *, causal, segment_ids, softmax_scale, with_lse):
    check_supported(q, k, v, causal=causal, segment_ids=segment_ids)
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    seg, seg_ptr = _segments_arg(segment_ids, q)
    o = torch.empty_like(q)
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _build.library().kft_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, sq, sk, hq, hk, d, int(causal), float(scale),
        _build.stream_handle(q.device))
    _build.check("kft_flash_attention_fwd", err)
    return o, lse


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
    o, _ = _launch_fwd(q, k, v, causal=causal, segment_ids=segment_ids,
                       softmax_scale=softmax_scale, with_lse=False)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            segment_ids: Optional[torch.Tensor] = None,
                            softmax_scale: Optional[float] = None):
    """``(o, lse)``: the forward that also writes each row's logsumexp,
    [b, hq, sq] f32.  CUDA: the kernel, as ``flash_attention`` takes it."""
    if q.device.type == "cpu":
        return plain_attention_with_lse(q, k, v, causal=causal,
                                        segment_ids=segment_ids,
                                        softmax_scale=softmax_scale)
    o, lse = _launch_fwd(q, k, v, causal=causal, segment_ids=segment_ids,
                         softmax_scale=softmax_scale, with_lse=True)
    flash_attention_fwd_lse.launches += 1
    return o, lse


flash_attention_fwd_lse.launches = 0


def _check_bwd(q, o, do, lse, g_lse=None, delta=None) -> None:
    """Raise ``ValueError`` on backward operands the kernels do not take
    (q, k, v are checked by ``check_supported``)."""
    b, sq, hq, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t is None:
            continue
        if (t.shape != q.shape or t.dtype != torch.bfloat16
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention backward: {name} {tuple(t.shape)} "
                f"{t.dtype} on {t.device} must be a contiguous, 16-byte "
                f"aligned bf16 tensor like q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("g_lse", g_lse), ("delta", delta)):
        if t is None:
            continue
        if (tuple(t.shape) != (b, hq, sq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention backward: {name} {tuple(t.shape)} "
                f"{t.dtype} must be contiguous f32 of shape {(b, hq, sq)}")


def flash_attention_dq(q, k, v, o, do, lse, *, causal: bool = False,
                       segment_ids=None, softmax_scale=None, g_lse=None):
    """``(dq, delta)``: dQ in q's dtype and delta = rowsum(dO * O) - g_lse,
    [b, hq, sq] f32, which ``flash_attention_dkv`` takes.  CUDA: the dq
    kernel (the operands of the forward, plus o, do, lse and g_lse f32
    [b, hq, sq] or None)."""
    if q.device.type == "cpu":
        return plain_attention_dq(q, k, v, o, do, lse, causal=causal,
                                  segment_ids=segment_ids,
                                  softmax_scale=softmax_scale, g_lse=g_lse)
    check_supported(q, k, v, causal=causal, segment_ids=segment_ids)
    _check_bwd(q, o, do, lse, g_lse=g_lse)
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    seg, seg_ptr = _segments_arg(segment_ids, q)
    dq = torch.empty_like(q)
    delta = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    err = _build.library().kft_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), seg_ptr,
        dq.data_ptr(), delta.data_ptr(), b, sq, sk, hq, hk, d, int(causal),
        float(scale), _build.stream_handle(q.device))
    _build.check("kft_flash_attention_bwd_dq", err)
    flash_attention_dq.launches += 1
    return dq, delta


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        segment_ids=None, softmax_scale=None):
    """``(dk, dv)`` in k's shape and dtype, each summed over the q heads of
    its kv head, from the lse and the delta of ``flash_attention_dq``.
    CUDA: the dk/dv kernel."""
    if q.device.type == "cpu":
        return plain_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                   segment_ids=segment_ids,
                                   softmax_scale=softmax_scale)
    check_supported(q, k, v, causal=causal, segment_ids=segment_ids)
    _check_bwd(q, None, do, lse, delta=delta)
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    seg, seg_ptr = _segments_arg(segment_ids, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _build.library().kft_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_ptr, dk.data_ptr(),
        dv.data_ptr(), b, sq, sk, hq, hk, d, int(causal), float(scale),
        _build.stream_handle(q.device))
    _build.check("kft_flash_attention_bwd_dkv", err)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``(o, lse)`` on the card: K2-lse forward, K3 then K4 backward.  Saves
    q, k, v, o, lse and the segment ids (no [sq, sk] residual).  A
    cotangent of lse enters delta (g_lse), so both outputs are
    differentiable, as the reference's ``flash_attention_with_lse`` is."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, softmax_scale):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         segment_ids=segment_ids,
                                         softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        ctx.softmax_scale = softmax_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if g_lse is not None:
            g_lse = g_lse.float().contiguous()
        kw = dict(causal=ctx.causal, segment_ids=segment_ids,
                  softmax_scale=ctx.softmax_scale)
        dq, delta = flash_attention_dq(q, k, v, o, do, lse, g_lse=g_lse, **kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             segment_ids: Optional[torch.Tensor] = None,
                             softmax_scale: Optional[float] = None):
    """Differentiable ``(o, lse)``, lse [b, hq, sq] f32.  CUDA tensors go
    through the kernels (``FlashAttentionFunction``); CPU tensors through
    ``plain_attention_with_lse`` and torch autograd."""
    if q.device.type == "cpu":
        return plain_attention_with_lse(q, k, v, causal=causal,
                                        segment_ids=segment_ids,
                                        softmax_scale=softmax_scale)
    return FlashAttentionFunction.apply(q, k, v, segment_ids, causal,
                                        softmax_scale)
