"""Ulysses sequence parallelism: two all-to-alls trade a sequence chunk of
every head for the whole sequence of a head group, attention runs there,
and the inverse trade brings the output back.

Counterpart of ``kubeflow_tpu/parallel/ulysses.py`` in the local view:
q/k/v and the output are this process's chunk [b, s/sp, h, d] of a
sequence split in rank order over ``sp``.  After the first all-to-all the
process holds the whole sequence of heads ``[r h/sp, (r + 1) h/sp)``,
the shape the flash kernel is built for, and attends with the port's
local attention (``ops/attention.py`` ``flash``: K2, or K2-lse with K3
and K4 under autograd, on the card).  Each all-to-all is an autograd
function whose backward is the inverse all-to-all.  The head count must
divide the axis; GQA k/v are repeated to every head first when their
heads do not.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops import attention
from kubeflow_tpu_torch.ops.cuda.flash_attention import repeat_kv
from kubeflow_tpu_torch.parallel.mesh import axis_size


def _all_to_all(x: torch.Tensor, group, scatter_dim: int,
                gather_dim: int) -> torch.Tensor:
    """Split ``x`` in ``n`` along ``scatter_dim``, send piece j to rank j
    of ``group`` and join what arrives along ``gather_dim`` in rank
    order (the reference's tiled ``all_to_all``)."""
    n = dist.get_world_size(group)
    inp = torch.stack([c.contiguous() for c in x.chunk(n, dim=scatter_dim)])
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(list(out.unbind(0)), dim=gather_dim)


class AllToAll(torch.autograd.Function):
    """``_all_to_all`` with the inverse trade as its backward."""

    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.group, ctx.dims = group, (scatter_dim, gather_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return _all_to_all(g, ctx.group, gather_dim, scatter_dim), None, \
            None, None


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, softmax_scale: Optional[float]
                    ) -> torch.Tensor:
    """Attention of one head group over the whole sequence (the port's
    flash op: the kernels on CUDA tensors, the plain version on CPU
    ones)."""
    return attention.flash(q, k, v, causal=causal,
                           softmax_scale=softmax_scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis_name: str = "sp", causal: bool = False,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this process's sequence chunk via two
    all-to-alls over ``axis_name``; the same contract as
    ``ring.ring_attention``.  ``ValueError`` when the heads do not divide
    the axis."""
    sp = axis_size(mesh, axis_name)
    h = q.shape[2]
    if h % sp:
        raise ValueError(
            f"n_heads={h} must divide the {axis_name!r} axis ({sp})")
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if k.shape[2] != h and k.shape[2] % sp:
        k = repeat_kv(k, h // k.shape[2])
        v = repeat_kv(v, h // v.shape[2])
    group = mesh.get_group(axis_name)
    qg, kg, vg = (AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    out = local_attention(qg, kg, vg, causal=causal, softmax_scale=scale)
    return AllToAll.apply(out.to(q.dtype), group, 1, 2)
