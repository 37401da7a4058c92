"""LM train steps of the port: the loss, its gradient and the optimizer
update, counterparts of ``kubeflow_tpu/train/steps.py``.

A step is ``step(state, batch) -> (state, metrics)``; the state is
updated in place (the module's parameters and the optimizer's moments),
where the reference returns a new pytree.  ``batch`` is ``tokens`` [b, s]
or ``(tokens, segment_ids)`` for packed rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class TokenNLL(torch.autograd.Function):
    """Per-token negative log-likelihood [...] from f32 logits [..., V]
    with the reference's fused backward (``_token_nll``,
    ``steps.py:78-112``): the forward keeps only the per-token lse beside
    the logits it was given (no log-softmax residual over the vocabulary),
    the backward writes d_logits = (softmax - onehot) * g in one pass."""

    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.long()
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
        ll = logits.gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, labels[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return d.mul_(g[..., None]), None


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return TokenNLL.apply(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, f32; ``weights``
    (labels' shape) make it a weighted mean (packed rows zero pad and
    cross-document targets)."""
    nll = token_nll(logits.float(), labels)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def _chunk_nll_sum(hidden, head_weight, labels, weights):
    logits = F.linear(hidden.float(), head_weight.float())
    return (token_nll(logits, labels) * weights).sum()


def chunked_cross_entropy(hidden: torch.Tensor, head_weight: torch.Tensor,
                          labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None, *,
                          chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy without the full logits: the head
    (``head_weight`` [vocab, dim], the port's layout) and the NLL run per
    ``chunk`` positions under ``torch.utils.checkpoint``, so one
    [b, chunk, vocab] f32 tile lives at a time in each direction and the
    backward recomputes each chunk's head (the reference's scan,
    ``steps.py:176-221``).  ``hidden`` [b, s, dim] is the final-normed
    output (``Llama(..., return_hidden=True)``)."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"seq len {s} not divisible by ce chunk {chunk}")
    w = (torch.ones(b, s, device=hidden.device) if weights is None
         else weights.float())
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        loss_sum = loss_sum + checkpoint(
            _chunk_nll_sum, hidden[:, sl], head_weight, labels[:, sl],
            w[:, sl], use_reentrant=False)
    return loss_sum / w.sum().clamp(min=1.0)


def adamw(params, lr: float, *, weight_decay: float = 1e-4
          ) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, decoupled weight decay 1e-4 (torch's own default is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The module (f32 master parameters), its optimizer and the count of
    applied updates."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self, grads: Dict[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update from ``grads`` (parameter name -> gradient),
        each cast to its parameter's dtype first (bf16 gradients onto f32
        master weights), as the reference's ``apply_gradients`` does."""
        for name, p in self.module.named_parameters():
            g = grads[name]
            p.grad = g if g.dtype == p.dtype else g.to(p.dtype)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def _unpack(batch):
    if isinstance(batch, (tuple, list)):
        return batch[0], (batch[1] if len(batch) > 1 else None)
    return batch, None


def lm_loss(module: nn.Module, params: Dict[str, torch.Tensor],
            tokens: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
            *, ce_chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token loss of ``module`` run with ``params`` in place of its
    own (``torch.func.functional_call``).  With ``segment_ids`` a target
    counts only when it continues the same document and is not a pad slot
    (``steps.py:281-301``).  With ``ce_chunk`` the head and the loss run
    per chunk over the full length, targets rolled left and the wrapped
    last position weighted 0."""
    kwargs = {} if segment_ids is None else {"segment_ids": segment_ids}
    if ce_chunk is not None:
        kwargs["return_hidden"] = True
    out = torch.func.functional_call(module, params, (tokens,), kwargs)
    shifted_valid = None
    if segment_ids is not None:
        shifted_valid = ((segment_ids[:, 1:] == segment_ids[:, :-1])
                         & (segment_ids[:, 1:] != 0))
    if ce_chunk is None:
        return cross_entropy(out[:, :-1], tokens[:, 1:],
                             weights=shifted_valid)
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = (torch.ones(b, s - 1, device=tokens.device)
             if shifted_valid is None else shifted_valid.float())
    w = torch.cat([valid, torch.zeros(b, 1, device=tokens.device)], dim=1)
    return chunked_cross_entropy(out, params["lm_head.weight"], targets, w,
                                 chunk=ce_chunk)


def make_lm_grad_fn(*, grad_dtype: Optional[torch.dtype] = None,
                    ce_chunk: Optional[int] = None) -> Callable:
    """``grad_fn(state, batch) -> (grads, metrics)``: the loss and the
    gradient of every parameter (by name).

    ``grad_dtype`` (``torch.bfloat16``): differentiate a copy of every f32
    parameter in that dtype, the head and the norm scales included, so the
    gradients come back in it (bf16 gradients, f32 master weights), as the
    reference's ``_cast_params`` does.  The model computes in its config
    dtype either way."""

    def grad_fn(state: TrainState, batch):
        tokens, segment_ids = _unpack(batch)
        params = {}
        for name, p in state.module.named_parameters():
            t = p.detach()
            if grad_dtype is not None and t.dtype == torch.float32:
                t = t.to(grad_dtype)
            params[name] = t.requires_grad_(True)
        loss = lm_loss(state.module, params, tokens, segment_ids,
                       ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads)), {"loss": loss.detach()}

    return grad_fn


def make_lm_train_step(*, grad_dtype: Optional[torch.dtype] = None,
                       ce_chunk: Optional[int] = None) -> Callable:
    """Next-token-prediction step; see ``make_lm_grad_fn``."""
    grad_fn = make_lm_grad_fn(grad_dtype=grad_dtype, ce_chunk=ce_chunk)

    def step(state: TrainState, batch):
        grads, metrics = grad_fn(state, batch)
        return state.apply_gradients(grads), metrics

    return step


def make_grad_accum_step(grad_fn: Callable, n_accum: int) -> Callable:
    """Split the batch's leading axis into ``n_accum`` microbatches, sum
    their gradients in f32 (each parameter's dtype), apply the mean once;
    metrics are the mean over microbatches (``steps.py:346-399``)."""
    if n_accum < 1:
        raise ValueError(f"n_accum must be >= 1, got {n_accum}")

    def split(x):
        if x.shape[0] % n_accum:
            raise ValueError(
                f"batch axis {x.shape[0]} not divisible by n_accum {n_accum}")
        return x.reshape((n_accum, x.shape[0] // n_accum) + x.shape[1:])

    def step(state: TrainState, batch):
        parts = ([split(x) for x in batch]
                 if isinstance(batch, (tuple, list)) else [split(batch)])
        acc = {name: torch.zeros_like(p)
               for name, p in state.module.named_parameters()}
        metrics_seq = []
        for i in range(n_accum):
            micro = tuple(x[i] for x in parts)
            grads, metrics = grad_fn(state, micro if len(micro) > 1
                                     else micro[0])
            for name, g in grads.items():
                acc[name].add_(g)
            metrics_seq.append(metrics)
        state.apply_gradients({name: a / n_accum for name, a in acc.items()})
        return state, {k: torch.stack([m[k] for m in metrics_seq]).mean()
                       for k in metrics_seq[0]}

    return step
