"""Train steps of the port: the loss, its gradient and the optimizer
update, counterparts of ``kubeflow_tpu/train/steps.py``.

A step is ``step(state, batch) -> (state, metrics)``; the state is
updated in place (the module's parameters, its batch stats and the
optimizer's moments), where the reference returns a new pytree.  An LM
``batch`` is ``tokens`` [b, s] or ``(tokens, segment_ids)`` for packed
rows; a classification batch is ``(inputs, labels)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.layers import BatchNorm
from kubeflow_tpu_torch.parallel import sharding


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


def vocab_shard_sums(logits: torch.Tensor, labels: torch.Tensor,
                     start: int, m: torch.Tensor) -> tuple:
    """``(sum of exp(logit - m), the target's logit)`` over one
    vocabulary shard whose first token is ``start``, ``m`` the rows'
    largest logit over every shard; the target's logit is 0 where the
    target lies in another shard.  Summed over the shards they give the
    whole vocabulary's."""
    rows = logits.shape[-1]
    local = labels - start
    inside = (local >= 0) & (local < rows)
    picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])
    return (torch.exp(logits - m[..., None]).sum(dim=-1),
            torch.where(inside, picked[..., 0], 0.0))


class VocabParallelNLL(torch.autograd.Function):
    """``TokenNLL`` over a vocabulary split over ``tp``: each rank holds
    f32 logits [..., V / tp] of its vocabulary range and the labels
    whole.  One all-reduce (max) over ``tp`` gives each row's largest
    logit, a second (sum) the sum of exponentials and the target's logit,
    which the rank holding it contributes; the backward writes this
    rank's d_logits = (softmax - onehot) * g with no exchange (the
    logits' input sums its gradient over ``tp``, ``copy_to_tp``)."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        labels = labels.long()
        start = tp.rank * logits.shape[-1]
        m = sharding.all_reduce_max(logits.amax(dim=-1), tp)
        sums = torch.stack(vocab_shard_sums(logits, labels, start, m))
        sumexp, ll = sharding.reduce_from_tp(sums, tp)
        lse = m + torch.log(sumexp)
        ctx.save_for_backward(logits, labels - start, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, local, lse = ctx.saved_tensors
        inside = (local >= 0) & (local < logits.shape[-1])
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, torch.where(inside, local, 0)[..., None],
                       -inside.to(d.dtype)[..., None])
        return d.mul_(g[..., None]), None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              tp: Optional[sharding.TPShard] = None) -> torch.Tensor:
    """Per-token NLL; with ``tp`` the logits are this rank's vocabulary
    shard (``VocabParallelNLL``)."""
    if tp is None:
        return TokenNLL.apply(logits, labels)
    return VocabParallelNLL.apply(logits, labels, tp)


def head_shard(module: nn.Module, params: Dict[str, torch.Tensor]
               ) -> Optional[sharding.TPShard]:
    """The ``tp`` shard of ``module``'s vocabulary when ``params`` hold a
    vocabulary-parallel ``lm_head`` (None: whole)."""
    return sharding.tp_shard(params["lm_head.weight"],
                             module.cfg.vocab_size)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  tp: Optional[sharding.TPShard] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, f32; ``weights``
    (labels' shape) make it a weighted mean (packed rows zero pad and
    cross-document targets); with ``tp`` the logits are this rank's
    vocabulary shard."""
    nll = token_nll(logits.float(), labels, tp)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def _chunk_nll_sum(hidden, head_weight, labels, weights, tp):
    logits = F.linear(hidden.float(), head_weight.float())
    return (token_nll(logits, labels, tp) * weights).sum()


def chunked_cross_entropy(hidden: torch.Tensor, head_weight: torch.Tensor,
                          labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None, *,
                          chunk: int = 1024,
                          tp: Optional[sharding.TPShard] = None
                          ) -> torch.Tensor:
    """Mean next-token cross-entropy without the full logits: the head
    (``head_weight`` [vocab, dim], the port's layout) and the NLL run per
    ``chunk`` positions under ``torch.utils.checkpoint``, so one
    [b, chunk, vocab] f32 tile lives at a time in each direction and the
    backward recomputes each chunk's head (the reference's scan,
    ``steps.py:176-221``).  ``hidden`` [b, s, dim] is the final-normed
    output (``Llama(..., return_hidden=True)``).  With ``tp`` the head is
    this rank's vocabulary shard (``VocabParallelNLL``)."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"seq len {s} not divisible by ce chunk {chunk}")
    hidden = sharding.copy_to_tp(hidden, tp)
    w = (torch.ones(b, s, device=hidden.device) if weights is None
         else weights.float())
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        loss_sum = loss_sum + checkpoint(
            _chunk_nll_sum, hidden[:, sl], head_weight, labels[:, sl],
            w[:, sl], tp, use_reentrant=False)
    return loss_sum / w.sum().clamp(min=1.0)


def adamw(params, lr: float, *, weight_decay: float = 1e-4
          ) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, decoupled weight decay 1e-4 (torch's own default is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def sgd(params, lr: float, *, momentum: float = 0.0,
        nesterov: bool = False) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum=, nesterov=)``: no dampening and no weight
    decay, so the trace starts at the first gradient (t = g, then
    t = momentum * t + g) and the update is lr * t, or lr * (g + momentum
    * t) with nesterov, as optax's ``trace`` gives."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=nesterov, weight_decay=0.0)


@dataclasses.dataclass
class TrainState:
    """The module (f32 master parameters, and its batch stats as
    buffers), its optimizer and the count of applied updates."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running stats of every ``BatchNorm`` (state-dict key ->
        buffer, updated in place by a training forward); empty for a
        model without them.  They ride in the module's state dict, so a
        checkpoint saves and restores them with the parameters."""
        return {f"{name}.{buf}": t
                for name, mod in self.module.named_modules()
                if isinstance(mod, BatchNorm)
                for buf, t in mod.named_buffers(recurse=False)}

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
            *, ce_chunk: Optional[int] = None, with_aux: bool = False,
            sequence: Optional[tuple] = None):
    """Next-token loss of ``module`` run with ``params`` in place of its
    own (``torch.func.functional_call``): the weighted mean NLL of
    ``next_token_targets``.  With ``segment_ids`` a target counts only when
    it continues the same document and is not a pad slot
    (``steps.py:281-301``).  With ``ce_chunk`` the head and the loss run
    per chunk (``chunked_cross_entropy``).  With ``sequence=(index,
    count)`` the model runs on that chunk of the sequence, the targets cut
    from the whole (``next_token_inputs``).  With ``with_aux`` returns
    ``(loss, aux)``, aux the MoE load-balancing loss averaged over
    layers.  Under ``tp`` (a vocabulary-parallel head in ``params``) the
    loss is the vocabulary-parallel cross-entropy over each rank's
    logits, which are never gathered."""
    tokens, segment_ids, targets, weights = next_token_inputs(
        tokens, segment_ids, sequence)
    tp = head_shard(module, params)
    kwargs = {} if segment_ids is None else {"segment_ids": segment_ids}
    if ce_chunk is not None:
        kwargs["return_hidden"] = True
    elif tp is not None:
        kwargs["vocab_shard"] = True
    if with_aux:
        kwargs["return_aux"] = True
    out = torch.func.functional_call(module, params, (tokens,), kwargs)
    if with_aux:
        out, aux = out
    if ce_chunk is None:
        loss = cross_entropy(out, targets, weights=weights, tp=tp)
    else:
        loss = chunked_cross_entropy(out, params["lm_head.weight"], targets,
                                     weights, chunk=ce_chunk, tp=tp)
    return (loss, aux) if with_aux else loss


def next_token_targets(tokens: torch.Tensor,
                       segment_ids: Optional[torch.Tensor] = None) -> tuple:
    """``(targets, weights)`` [b, s] over the whole sequence: targets
    rolled left, the last position weighted 0; with ``segment_ids`` a
    target counts only when it continues the same document and is not a
    pad slot."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    if segment_ids is None:
        valid = torch.ones(b, s - 1, device=tokens.device)
    else:
        valid = ((segment_ids[:, 1:] == segment_ids[:, :-1])
                 & (segment_ids[:, 1:] != 0)).float()
    return targets, torch.cat(
        [valid, torch.zeros(b, 1, device=tokens.device)], dim=1)


def next_token_inputs(tokens: torch.Tensor,
                      segment_ids: Optional[torch.Tensor] = None,
                      sequence: Optional[tuple] = None) -> tuple:
    """``(tokens, segment_ids, targets, weights)``: ``next_token_targets``
    over the whole sequence, then with ``sequence=(index, count)`` all four
    cut to that chunk of ``count`` equal chunks (a sequence split over
    ``sp``: a chunk's last position predicts the next chunk's first
    token)."""
    targets, weights = next_token_targets(tokens, segment_ids)
    if sequence is None:
        return tokens, segment_ids, targets, weights
    index, count = sequence
    s = tokens.shape[1]
    if s % count:
        raise ValueError(f"seq len {s} does not split over sp={count}")
    cut = slice(index * s // count, (index + 1) * s // count)
    return (tokens[:, cut],
            None if segment_ids is None else segment_ids[:, cut],
            targets[:, cut], weights[:, cut])


def lm_batch_weight(batch, *, sequence: Optional[tuple] = None
                    ) -> torch.Tensor:
    """The count ``lm_loss`` divides the batch's NLL sum by (f32, 0-d):
    its weighted targets, of chunk ``sequence`` when given."""
    tokens, segment_ids = _unpack(batch)
    return next_token_inputs(tokens, segment_ids, sequence)[3].sum()


def classification_batch_weight(batch) -> torch.Tensor:
    """The count ``classification_loss`` divides by (f32, 0-d): the
    batch's rows."""
    labels = batch[1]
    return torch.tensor(float(labels.shape[0]), device=labels.device)


def _differentiable(state: TrainState, params: Optional[dict],
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Name -> a leaf that requires grad: each of ``params`` (default: the
    module's own parameters) detached, f32 ones cast to ``dtype`` when
    given."""
    if params is None:
        params = dict(state.module.named_parameters())
    out = {}
    for name, p in params.items():
        t = p.detach()
        if dtype is not None and t.dtype == torch.float32:
            t = t.to(dtype)
        out[name] = t.requires_grad_(True)
    return out


def make_lm_grad_fn(*, aux_loss_weight: float = 0.0,
                    grad_dtype: Optional[torch.dtype] = None,
                    ce_chunk: Optional[int] = None) -> Callable:
    """``grad_fn(state, batch, *, params=None, sequence=None, scale=None)
    -> (grads, metrics)``: the loss and the gradient of every parameter
    (by name).  For a sharded step: ``params`` are tensors to
    differentiate at in place of the module's own (its gathered
    parameters), ``sequence`` is ``lm_loss``'s, and ``scale`` multiplies
    the objective before it is differentiated (the process's share of the
    global mean; the metrics stay this batch's).  ``grad_fn.batch_weight``
    is ``lm_batch_weight``, the count the loss is a mean over.

    ``aux_loss_weight`` > 0 adds that multiple of the MoE load-balancing
    loss (the layers' mean) to the objective, and the metrics gain
    ``moe_aux_loss``; ``loss`` stays the cross-entropy alone, as the
    reference reports it.

    ``grad_dtype`` (``torch.bfloat16``): differentiate a copy of every f32
    parameter in that dtype, the head and the norm scales included, so the
    gradients come back in it (bf16 gradients, f32 master weights), as the
    reference's ``_cast_params`` does.  The model computes in its config
    dtype either way."""

    def grad_fn(state: TrainState, batch, *, params: Optional[dict] = None,
                sequence: Optional[tuple] = None,
                scale: Optional[torch.Tensor] = None):
        tokens, segment_ids = _unpack(batch)
        params = _differentiable(state, params, grad_dtype)
        kw = dict(ce_chunk=ce_chunk, sequence=sequence)
        if aux_loss_weight:
            loss, aux = lm_loss(state.module, params, tokens, segment_ids,
                                with_aux=True, **kw)
            total = loss + aux_loss_weight * aux
        else:
            total = loss = lm_loss(state.module, params, tokens,
                                   segment_ids, **kw)
        if scale is not None:
            total = total * scale
        grads = torch.autograd.grad(total, list(params.values()))
        metrics = {"loss": loss.detach()}
        if aux_loss_weight:
            metrics["moe_aux_loss"] = aux.detach()
        return dict(zip(params, grads)), metrics

    grad_fn.batch_weight = lm_batch_weight
    return grad_fn


def make_lm_train_step(*, aux_loss_weight: float = 0.0,
                       grad_dtype: Optional[torch.dtype] = None,
                       ce_chunk: Optional[int] = None) -> Callable:
    """Next-token-prediction step; see ``make_lm_grad_fn``."""
    grad_fn = make_lm_grad_fn(aux_loss_weight=aux_loss_weight,
                              grad_dtype=grad_dtype, ce_chunk=ce_chunk)

    def step(state: TrainState, batch):
        grads, metrics = grad_fn(state, batch)
        return state.apply_gradients(grads), metrics

    return step


def _check_batch_stats(state: TrainState, has_batch_stats: bool) -> None:
    """The reference threads batch stats through a step only when told
    to; here a training forward updates them in place, so the flag must
    say whether the model has them."""
    if bool(state.batch_stats) != has_batch_stats:
        raise ValueError(
            f"has_batch_stats={has_batch_stats}, but the model has "
            f"{len(state.batch_stats)} batch-stat buffers")


def classification_loss(module: nn.Module, params: Dict[str, torch.Tensor],
                        inputs: torch.Tensor, labels: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None):
    """``(loss, accuracy)`` of a classifier run in training mode with
    ``params`` in place of its own: mean softmax cross-entropy over the
    integer labels and the share of rows whose argmax is the label, both
    f32.  No attention mask is passed, as in the reference's step."""
    kwargs = {"train": True}
    if generator is not None:
        kwargs["generator"] = generator
    logits = torch.func.functional_call(module, params, (inputs,), kwargs)
    acc = (logits.argmax(-1) == labels).float().mean()
    return cross_entropy(logits, labels), acc


def make_classification_grad_fn(*, has_batch_stats: bool,
                                has_dropout: bool = False) -> Callable:
    """``grad_fn(state, (inputs, labels), generator=None, *, params=None,
    scale=None) -> (grads, metrics)`` for image and sequence classifiers
    (``steps.py:129-157``): the gradient of every parameter by name,
    ``loss`` and ``accuracy``; ``params`` and ``scale`` as
    ``make_lm_grad_fn``'s.  The
    forward updates the model's batch stats in place, where the reference
    returns them.  ``has_dropout`` requires the ``generator`` the dropout
    draws from.  ``grad_fn.batch_weight`` is
    ``classification_batch_weight``."""

    def grad_fn(state: TrainState, batch,
                generator: Optional[torch.Generator] = None, *,
                params: Optional[dict] = None,
                scale: Optional[torch.Tensor] = None):
        _check_batch_stats(state, has_batch_stats)
        if has_dropout and generator is None:
            raise ValueError("has_dropout needs a torch.Generator")
        inputs, labels = batch
        params = _differentiable(state, params)
        loss, acc = classification_loss(
            state.module, params, inputs, labels,
            generator=generator if has_dropout else None)
        grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                    list(params.values()))
        return dict(zip(params, grads)), {"loss": loss.detach(),
                                          "accuracy": acc}

    grad_fn.batch_weight = classification_batch_weight
    return grad_fn


def make_classification_train_step(*, has_batch_stats: bool,
                                   has_dropout: bool = False) -> Callable:
    """Step for image and sequence classifiers, ``step(state, (inputs,
    labels), generator=None)``; see ``make_classification_grad_fn``."""
    grad_fn = make_classification_grad_fn(has_batch_stats=has_batch_stats,
                                          has_dropout=has_dropout)

    def step(state: TrainState, batch,
             generator: Optional[torch.Generator] = None):
        grads, metrics = grad_fn(state, batch, generator)
        return state.apply_gradients(grads), metrics

    return step


def make_grad_accum_step(grad_fn: Callable, n_accum: int, *,
                         has_batch_stats: bool = False) -> Callable:
    """Split the batch's leading axis into ``n_accum`` microbatches, sum
    their gradients in f32 (each parameter's dtype), apply the mean once;
    metrics are the mean over microbatches (``steps.py:346-399``).  With
    ``has_batch_stats`` the microbatches' forwards update the stats in
    turn, so the last one's stats win, each having started from the one
    before, as the reference's scan carries them."""
    if n_accum < 1:
        raise ValueError(f"n_accum must be >= 1, got {n_accum}")

    def step(state: TrainState, batch):
        _check_batch_stats(state, has_batch_stats)
        acc = {name: torch.zeros_like(p)
               for name, p in state.module.named_parameters()}
        metrics_seq = []
        for micro in split_microbatches(batch, n_accum):
            grads, metrics = grad_fn(state, micro)
            for name, g in grads.items():
                acc[name].add_(g)
            metrics_seq.append(metrics)
        state.apply_gradients({name: a / n_accum for name, a in acc.items()})
        return state, {k: torch.stack([m[k] for m in metrics_seq]).mean()
                       for k in metrics_seq[0]}

    return step


def split_microbatches(batch, n: int) -> list:
    """The batch's rows as ``n`` microbatches of its form (a tensor, or a
    tuple of tensors split alike)."""
    parts = list(batch) if isinstance(batch, (tuple, list)) else [batch]
    for x in parts:
        if x.shape[0] % n:
            raise ValueError(
                f"batch axis {x.shape[0]} not divisible by n_accum {n}")
    return [micro if len(micro) > 1 else micro[0]
            for micro in zip(*(x.chunk(n) for x in parts))]
