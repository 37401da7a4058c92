"""Mixture-of-experts MLP (Mixtral-style top-k routed SwiGLU experts) —
counterpart of ``kubeflow_tpu/models/moe.py``.

The routing is the reference's, decision for decision:

* the router runs in f32 (``router.weight`` [e, d] is always f32), then
  a softmax over the experts;
* each token chooses its top-k experts by a stable descending sort, so a
  tie goes to the lower expert index, as ``jax.lax.top_k`` breaks it;
* ``token_mask`` [b, s] (True on real tokens) takes padding out of the
  routing: a masked token chooses nothing;
* each batch row is a routing group with ``capacity = max(1, int(s * k *
  capacity_factor / e))`` places an expert, ``s`` the call's padded
  length; places go in routing order, token by token and within a token
  its first choice before its second, and a choice past the capacity is
  dropped (its token keeps only the residual);
* a kept choice's gate is its full softmax probability (not
  renormalised over the kept choices).

The reference moves tokens with dense one-hot einsums over a
[b, s, e, capacity] tensor, which XLA tiles onto the MXU.  Eager PyTorch
would build that tensor (1.3 GB a layer at s 8192), so ``MoeMlp``
dispatches by index instead: the kept tokens are copied into zeroed
expert buffers [e, b, capacity, d], the experts run as batched matmuls,
and each kept choice's output row is gathered back and weighted by its
gate.  It is the same function: a buffer place holds one token or
zeros, and a token's output sums its kept choices' gated rows in f32.
``dense_dispatch`` is the plain transcription of the reference's
einsums, kept beside the module to check the index dispatch.

The load-balancing loss is the reference's (Switch eq. 4): ``e * sum_e
f_e * p_e / k`` over the real tokens; ``forward`` returns it beside the
output and ``Llama`` averages it over layers (``return_aux``).

Under a mesh with an ``ep`` axis a process holds ``e / ep`` of the
experts (``parallel/sharding.py``: ``w_gate``/``w_up``/``w_down`` split
on their expert axis), the reference's GShard lowering
(``kubeflow_tpu/models/moe.py:117-133``): routing, dispatch and combine
stay on each process's rows, one ``all_to_all_single`` over ``ep`` sends
the expert buffers [e, b, c, d] to the processes that hold each expert,
which compute with their experts as stored, and a second brings the
results back.  The backward runs the same exchanges in reverse, so an
expert's gradient is its own process's, summed over every process's
tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import Linear, lecun_normal_
from kubeflow_tpu_torch.parallel import sharding


@dataclasses.dataclass
class Routing:
    """One call's routing: ``probs`` [b, s, e] f32, each token's choices
    ``expert`` [b, s, k] (best first), each choice's place in its
    expert's buffer ``slot`` [b, s, k], whether it is kept ``keep``
    [b, s, k] (a real token's choice within the capacity), its gate
    ``gates`` [b, s, k] f32 (0 where dropped), the ``capacity`` and the
    load-balancing loss ``aux``."""

    probs: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    capacity: int
    aux: torch.Tensor

    def dispatch_mask(self) -> torch.Tensor:
        """The reference's dispatch tensor [b, s, e, capacity] (1 where a
        token sits in an expert's buffer place), built from the indices."""
        b, s, k = self.expert.shape
        e = self.probs.shape[-1]
        out = torch.zeros(b, s, e, self.capacity, device=self.expert.device)
        bi, si, ki = torch.nonzero(self.keep, as_tuple=True)
        out[bi, si, self.expert[bi, si, ki], self.slot[bi, si, ki]] = 1.0
        return out


def capacity_of(s: int, k: int, capacity_factor: float, e: int) -> int:
    """Places an expert has in one batch row of padded length ``s``."""
    return max(1, int(s * k * capacity_factor / e))


def _aux_loss(onehot, probs, token_mask, e: int, k: int) -> torch.Tensor:
    """e * sum_e (share of choices for e) * (mean prob of e) / k, over the
    real tokens when ``token_mask`` is given."""
    if token_mask is not None:
        w = token_mask.float()[:, :, None]
        denom = w.sum().clamp(min=1.0)
        token_frac = (onehot.sum(2) * w).sum(dim=(0, 1)) / denom
        prob_frac = (probs * w).sum(dim=(0, 1)) / denom
    else:
        token_frac = onehot.sum(2).mean(dim=(0, 1))
        prob_frac = probs.mean(dim=(0, 1))
    return e * (token_frac * prob_frac).sum() / k


class MoeMlp(nn.Module):
    """Top-k routed SwiGLU experts over batched expert tensors: ``w_gate``
    and ``w_up`` [e, d, f], ``w_down`` [e, f, d] (the reference's
    layout), stored in ``param_dtype`` and computed in ``dtype``."""

    def __init__(self, dim: int, hidden_dim: int, n_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = Linear(dim, n_experts, dtype=torch.float32,
                             param_dtype=torch.float32, device=device)
        pd = param_dtype or dtype
        expert = lambda *shape: nn.Parameter(torch.empty(
            shape, dtype=pd, device=device), requires_grad=False)
        self.w_gate = expert(n_experts, dim, hidden_dim)
        self.w_up = expert(n_experts, dim, hidden_dim)
        self.w_down = expert(n_experts, hidden_dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``lecun_normal`` on the batched tensors, whose fan-in
        counts the expert axis: e * d (e * f for ``w_down``).  The router
        resets itself (fan-in d)."""
        e, d, f = self.w_gate.shape
        lecun_normal_(self.w_gate, e * d, generator)
        lecun_normal_(self.w_up, e * d, generator)
        lecun_normal_(self.w_down, e * f, generator)

    def route(self, x: torch.Tensor,
              token_mask: Optional[torch.Tensor] = None) -> Routing:
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        capacity = capacity_of(s, k, self.capacity_factor, e)
        probs = torch.softmax(self.router(x.float()), dim=-1)
        expert = torch.sort(probs, dim=-1, descending=True,
                            stable=True).indices[..., :k]
        onehot = F.one_hot(expert, e).float()                 # [b, s, k, e]
        if token_mask is not None:
            onehot = onehot * token_mask.float()[:, :, None, None]
        flat = onehot.reshape(b, s * k, e)
        pos = (flat.cumsum(dim=1) - flat).reshape(b, s, k, e)
        slot = (pos * onehot).sum(-1)
        keep = (onehot.sum(-1) > 0) & (slot < capacity)
        gates = probs.gather(-1, expert) * keep
        return Routing(probs, expert, slot.long(), keep, gates, capacity,
                       _aux_loss(onehot, probs, token_mask, e, k))

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(y [b, s, d] in x's dtype, aux)``."""
        r = self.route(x, token_mask)
        b, s, d = x.shape
        e, k, c = self.n_experts, self.top_k, r.capacity
        dt = self.dtype
        # Each kept choice's row in the flat buffers [e * b * c] (expert,
        # then batch row, then place); a dropped choice writes the spare
        # last row, which no expert reads, and gathers row 0 under a 0
        # gate.
        rows = torch.arange(b, device=x.device)[:, None, None]
        dest = (r.expert * b + rows) * c + r.slot
        spare = e * b * c
        xd = x.to(dt)
        src = xd[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
        buf = xd.new_zeros(spare + 1, d).index_copy(
            0, torch.where(r.keep, dest, spare).reshape(-1), src)
        xin = buf[:spare].view(e, b * c, d)
        w_gate, w_up, w_down = self.w_gate, self.w_up, self.w_down
        group = sharding.ep_group(w_gate.shape[0], e)
        if group is not None:
            # [ep, e / ep, b * c, d]: block j to process j, which returns
            # its experts' rows of every process, [e / ep, ep * b * c, d].
            n = group.size()
            xin = sharding.expert_all_to_all(xin, group).view(
                n, e // n, b * c, d).transpose(0, 1).reshape(
                    e // n, n * b * c, d)
        h = F.silu(torch.bmm(xin, w_gate.to(dt))) * torch.bmm(
            xin, w_up.to(dt))
        out = torch.bmm(h, w_down.to(dt))
        if group is not None:
            out = sharding.expert_all_to_all(
                out.view(e // n, n, b * c, d).transpose(0, 1).reshape(
                    e, b * c, d), group)
        out = out.reshape(spare, d)
        picked = out.index_select(
            0, torch.where(r.keep, dest, 0).reshape(-1)).view(b, s, k, d)
        y = (r.gates.to(dt).float()[..., None] * picked.float()).sum(2)
        return y.to(x.dtype), r.aux


def dense_dispatch(moe: MoeMlp, x: torch.Tensor,
                   token_mask: Optional[torch.Tensor] = None):
    """The reference's one-hot einsums (``kubeflow_tpu/models/moe.py``
    ``:68-134``) on ``moe``'s weights, for checks only (it builds the
    [b, s, k, e, capacity] position one-hot).  Returns ``(y, aux,
    dispatch [b, s, e, capacity])``."""
    b, s, _ = x.shape
    e, k, dt = moe.n_experts, moe.top_k, moe.dtype
    capacity = capacity_of(s, k, moe.capacity_factor, e)
    probs = torch.softmax(moe.router(x.float()), dim=-1)
    topk_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :k]
    onehot = F.one_hot(topk_idx, e).float()
    if token_mask is not None:
        onehot = onehot * token_mask.float()[:, :, None, None]
    flat = onehot.reshape(b, s * k, e)
    pos = (flat.cumsum(dim=1) - flat).reshape(b, s, k, e)
    keep = (pos < capacity) * onehot
    # jax.nn.one_hot gives a zero row for a position past the capacity.
    pos_oh = (pos.long()[..., None] == torch.arange(
        capacity, device=x.device)).float()                # [b, s, k, e, c]
    dispatch = torch.einsum("bske,bskec->bsec", keep, pos_oh)
    gates = torch.einsum("bse,bske->bsk", probs, keep)
    combine = torch.einsum("bsk,bske,bskec->bsec", gates, keep, pos_oh)
    aux = _aux_loss(onehot, probs, token_mask, e, k)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xin, moe.w_gate.to(dt))) \
        * torch.einsum("ebcd,edf->ebcf", xin, moe.w_up.to(dt))
    out = torch.einsum("ebcf,efd->ebcd", h, moe.w_down.to(dt))
    y = torch.einsum("bsec,ebcd->bsd", combine.to(dt), out)
    return y.to(x.dtype), aux, dispatch
