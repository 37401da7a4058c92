"""Pipeline parallelism over the ``pp`` axis: GPipe and the interleaved
(circular) schedule.

Counterpart of ``kubeflow_tpu/parallel/pipeline.py`` in the local view.
``pipeline_apply(fn, stage_params, x)`` is ``x`` fed through ``fn(params_0,
.)``, then ``fn(params_1, .)``, ... in stage order, microbatched along
the leading axis.  Every process passes the stacked parameters of all
stages (leading axis ``pp * interleave``) and its own rows ``x`` of the
batch (replicated over ``pp``); it applies its own stage(s) and returns
the whole output, replicated over ``pp``.

The schedule is the reference's tick for tick: each tick every stage
applies ``fn`` to what it holds (stage 0 injects the next microbatch),
the last stage records its finished microbatch, and every stage hands its
activation on with ``StageShift``, a send/recv autograd function whose
backward sends the gradient back.  The ticks are branch-free: drained
and bubble ticks still compute and still send, and every tick's values
stay in the autograd graph (``torch.where``), so the backward's sends and
receives run on every stage in the same order.  The result is gathered
from the last stage by a sum over ``pp`` whose backward is the identity
(each stage holds the same cotangent of the replicated output).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from kubeflow_tpu_torch.parallel.mesh import axis_index, axis_size
from kubeflow_tpu_torch.parallel.sharding import all_reduce_sum


class StageShift(torch.autograd.Function):
    """Send ``x`` to global rank ``send_to`` (None: no one) and receive a
    tensor of its shape from ``recv_from`` (None: zeros); the backward
    sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group, send_to, recv_from):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _exchange(x, send_to, recv_from, group)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.recv_from, ctx.send_to, ctx.group), None,
                None, None)


def _exchange(x, send_to, recv_from, group):
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x, send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _SumOverStages(torch.autograd.Function):
    """All-reduce over ``pp``; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_tree(stage_params, index: int):
    return pytree.tree_map(lambda p: p[index], stage_params)


def pipeline_apply(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh,
                   n_micro: int, interleave: int = 1,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run this process's rows ``x`` through the stages of ``fn`` over the
    ``pp`` axis.  ``stage_params``: a pytree whose leaves have a leading
    stage axis of ``pp * interleave`` in application order.  ``n_micro``
    divides ``x``'s rows.  ``interleave=1`` is GPipe (process d applies
    stage d; bubble pp - 1 ticks of n_micro + pp - 1); ``interleave=v``
    the circular schedule (process d applies stages d, pp + d, ...;
    activations lap the ring v times; needs n_micro <= pp).
    Differentiable in ``stage_params`` (each process's gradient is nonzero
    in its own stages' rows) and ``x``."""
    n_stages = axis_size(mesh, axis_name)
    total_stages = n_stages * interleave
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if interleave > 1 and n_micro > n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro <= pp ({n_stages}), got "
            f"{n_micro}; accumulate gradients across calls instead")
    for leaf in pytree.tree_leaves(stage_params):
        if leaf.shape[0] != total_stages:
            raise ValueError(
                f"stage_params leaves need leading axis {total_stages}, "
                f"got {tuple(leaf.shape)}")
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    stage = axis_index(mesh, axis_name)
    group = mesh.get_group(axis_name)
    peer = lambda i: dist.get_global_rank(group, i % n_stages)
    xs = list(x.chunk(n_micro))
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    if interleave == 1:
        # GPipe: no wrap edge; stage 0 receives zeros, the last sends none.
        send_to = peer(stage + 1) if stage < n_stages - 1 else None
        recv_from = peer(stage - 1) if stage > 0 else None
        ticks, emit_after = n_micro + n_stages - 1, n_stages - 1
    else:
        send_to, recv_from = peer(stage + 1), peer(stage - 1)
        ticks = interleave * n_stages + n_micro - 1
        emit_after = interleave * n_stages - 1
    state = torch.zeros_like(xs[0])
    outputs = [torch.zeros_like(m) for m in xs]
    for t in range(ticks):
        inject = xs[min(t, n_micro - 1)]
        if interleave == 1:
            params = _stage_tree(stage_params, stage)
            x_in = torch.where(first, inject, state)
        else:
            # Local round r of process d is global stage r * pp + d.
            r = min(max((t - stage) // n_stages, 0), interleave - 1)
            params = _stage_tree(stage_params, r * n_stages + stage)
            x_in = torch.where(first & (t < n_micro), inject, state)
        y = fn(params, x_in)
        out_idx = t - emit_after
        idx = min(max(out_idx, 0), n_micro - 1)
        done = last & (0 <= out_idx < n_micro)
        outputs[idx] = torch.where(done, y, outputs[idx])
        state = StageShift.apply(y, group, send_to, recv_from)
    # The final shift's value is never read; keep it in the graph (weight
    # 0) so its backward exchange runs on every stage.
    result = torch.where(last, torch.cat(outputs), torch.zeros_like(x))
    result = result + 0.0 * state.sum()
    return _SumOverStages.apply(result, group)


def stack_stage_params(per_stage: list) -> Any:
    """Stack a list of per-stage parameter pytrees into the [P, ...]
    layout."""
    leaves = [pytree.tree_flatten(p) for p in per_stage]
    spec = leaves[0][1]
    stacked = [torch.stack(xs) for xs in zip(*(lv for lv, _ in leaves))]
    return pytree.tree_unflatten(stacked, spec)
