"""Sharded training: place a train state on a mesh by the partition rules
and build the step that trains it there.

Counterpart of ``kubeflow_tpu/parallel/train.py``.  ``shard_train_state``
keeps each process's shard of every parameter (``sharding.shard_params``:
``fsdp`` and the other axes of a rule split it, ``Layout`` records how),
and the optimizer updates only those shards, so its moments are sharded
alike.  The step gathers every parameter at its start: whole over every
axis but ``tp`` and ``ep``, and over those too unless the model computes
with its shard along them (the model's ``tp_local``, and ``ep_local``
for the MoE experts, which ``models/moe.py`` computes as their ``ep``
shards).  So parameters and optimizer
state are stored sharded, but a step holds whole parameters and
gradients at its peak, as under ZeRO-1, where the reference's ZeRO-3
gathers each at its use.  The step runs the one-process grad function of
``train/steps.py`` on the gathered tensors (``params=``), so both paths
share one loss, and the CUDA kernels see plain tensors.  Each gradient
then goes back to its parameter's layout: reduce-scattered over the data
axes that shard the parameter, all-reduced over those that do not (and
over ``sp`` when the sequence is split), cut to the ``tp`` shard where it
was gathered whole.  On a mesh of one process nothing is exchanged.

The loss is the global mean: the grad function's objective, the mean
over this process's part of the batch, is scaled before it is
differentiated (``scale``) by the process's weight count
(``grad_fn.batch_weight``: the valid targets or the rows) over the count
summed across the processes, so the gradients summed over the processes
are those of the global mean whatever each process's count (packed rows
give unequal counts).  The scale goes in before the backward because a
split sequence's processes exchange gradients in it (ring and Ulysses
attention).  Metrics are combined the same way.  A step returns the
same ``(state, metrics)`` as the one-process step, the state updated in
place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from kubeflow_tpu_torch.parallel.context import global_mesh
from kubeflow_tpu_torch.parallel.mesh import AXIS_NAMES, axis_index, axis_size
from kubeflow_tpu_torch.parallel.sharding import (
    Rules,
    all_gather_dim,
    all_reduce_sum,
    batch_sharding,
    data_axes,
    layout_for,
    local_axes,
    local_shard,
    reduce_scatter_dim,
    shard_params,
)
from kubeflow_tpu_torch.train.checkpoint import optimizer_state_by_name
from kubeflow_tpu_torch.train.steps import TrainState, split_microbatches


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """A ``TrainState`` whose module holds this process's shards of its
    parameters (``layouts``: name -> ``sharding.Layout``) over ``mesh``,
    and whose optimizer updates those shards.  ``train/checkpoint.py``
    saves it as the full, unsharded state (``full_state``) and restores
    it into its shards (``load_full_state``)."""

    mesh: Any = None
    layouts: dict = dataclasses.field(default_factory=dict)

    def gather(self, name: str, t: torch.Tensor, axes=AXIS_NAMES
               ) -> torch.Tensor:
        """A shard (of parameter ``name``, or of a tensor laid out like
        it) gathered over ``axes``."""
        for axis, dim in self.layouts[name].shards:
            if axis in axes:
                t = all_gather_dim(t, self.mesh.get_group(axis), dim)
        return t

    def full_state(self) -> tuple:
        """``(params, optimizer state by name)``, whole and on the CPU:
        the module's state dict and ``checkpoint.optimizer_state_by_name``
        with every shard gathered.  Every process must call it."""
        params = {}
        for name, t in self.module.state_dict().items():
            if name in self.layouts:
                t = self.gather(name, t)
            params[name] = t.detach().cpu().clone()
        optim = optimizer_state_by_name(self.module, self.optimizer)
        for name, per in optim["state"].items():
            optim["state"][name] = {
                k: (v if not isinstance(v, torch.Tensor) else
                    (self.gather(name, v) if v.ndim else v).cpu().clone())
                for k, v in per.items()}
        return params, optim

    def load_full_state(self, params: dict, optim: Optional[dict]) -> tuple:
        """Whole tensors (``full_state``'s form, a one-process checkpoint's
        files) -> this process's shards: ``(params, optim)`` to load
        into the module and optimizer as a one-process state's."""
        params = {k: (local_shard(v, self.layouts[k], self.mesh)
                      if k in self.layouts else v) for k, v in params.items()}
        if optim is not None:
            optim = dict(optim, state={
                name: {k: (local_shard(v, self.layouts[name], self.mesh)
                           if isinstance(v, torch.Tensor) and v.ndim > 0
                           else v) for k, v in per.items()}
                for name, per in optim["state"].items()})
        return params, optim


def shard_train_state(state: TrainState, mesh, rules: Rules
                      ) -> ShardedTrainState:
    """Place a state built the same way on every process onto ``mesh``:
    its module keeps its parameters' shards (``sharding.shard_params``)
    and its optimizer is rebuilt over them with the same param groups.
    Shard a state before its first update (restore a checkpoint after)."""
    if state.optimizer.state:
        raise ValueError("shard a train state before its first update; "
                         "restore a checkpoint into the sharded state")
    module = state.module
    names = {id(p): n for n, p in module.named_parameters()}
    groups = [[names[id(p)] for p in g["params"]]
              for g in state.optimizer.param_groups]
    layouts = shard_params(module, mesh, rules)
    params = dict(module.named_parameters())
    optimizer = type(state.optimizer)([
        {**{k: v for k, v in g.items() if k != "params"},
         "params": [params[n] for n in group]}
        for g, group in zip(state.optimizer.param_groups, groups)])
    return ShardedTrainState(module, optimizer, state.step, mesh=mesh,
                             layouts=layouts)


def reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the processes along ``axes`` (no gradient)."""
    t = t.detach()
    for axis in axes:
        t = all_reduce_sum(t, mesh.get_group(axis))
    return t


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How the step handles one parameter: the axes it is gathered over,
    and for its gradient the axes to reduce-scatter over (with the
    dimension), to all-reduce over, and the ``tp`` dimension to cut back
    to a shard (None: none)."""

    gather: tuple
    scatter: tuple
    reduce: tuple
    cut_tp: Optional[int]


def _plan(module, name: str, layout, reduce_axes) -> _Plan:
    tp_dim = layout.axis_dim("tp")
    # The axes the model computes along with its shard: no gather, and no
    # exchange of the gradient, which is already the shard's (an ep
    # shard's sums every process's tokens through the all-to-alls).
    keep = local_axes(module, name)
    gather = tuple(a for a, _ in layout.shards if a not in keep)
    scatter = tuple((a, d) for a, d in layout.shards
                    if a in reduce_axes and a not in keep)
    sharded = {a for a, _ in layout.shards}
    return _Plan(gather, scatter,
                 tuple(a for a in reduce_axes if a not in sharded),
                 None if "tp" in keep else tp_dim)


def _gathered(state, plans) -> dict:
    """Each parameter gathered over its plan's axes (no gradient)."""
    return {name: state.gather(name, p.detach(), plans[name].gather)
            for name, p in state.module.named_parameters()}


def _reduce_grads(state, plans, grads: dict) -> dict:
    """Gradients of the gathered parameters -> gradients of this
    process's shards."""
    mesh, out = state.mesh, {}
    for name, g in grads.items():
        plan = plans[name]
        for axis, dim in plan.scatter:
            g = reduce_scatter_dim(g, mesh.get_group(axis), dim)
        for axis in plan.reduce:
            g = all_reduce_sum(g, mesh.get_group(axis))
        if plan.cut_tp is not None:
            g = g.chunk(axis_size(mesh, "tp"), dim=plan.cut_tp)[
                axis_index(mesh, "tp")]
        out[name] = g.contiguous()
    return out


def make_sharded_train_step(grad_fn: Callable, state: ShardedTrainState,
                            mesh, rules: Rules, *, n_accum: int = 1,
                            shard_sequence: bool = False):
    """``(sharded_step, batch_sharding)``: the train step of ``grad_fn``, a
    grad function of ``train/steps.py`` (``make_lm_grad_fn`` or
    ``make_classification_grad_fn``), over ``n_accum`` microbatches as
    ``make_grad_accum_step`` takes them, on a state from
    ``shard_train_state`` with ``rules``.  ``sharded_step(state, batch)``
    takes this process's rows of the global batch (``batch_sharding``),
    runs under ``global_mesh(mesh)`` and returns ``(state, metrics)`` with
    global metrics.  With ``shard_sequence`` an LM batch's sequence is
    split over ``sp`` too (the grad function's ``sequence``: targets cut
    from the whole sequence first), which needs ``impl="ring"`` or
    ``"ulysses"`` attention; otherwise ``sp`` ranks compute the same rows,
    as the reference's trainer does.  Batch statistics are not
    synchronized across a data-parallel mesh (a model with them raises
    there), and no dropout generator is passed (a grad function with
    dropout raises)."""
    if not hasattr(grad_fn, "batch_weight"):
        raise TypeError("make_sharded_train_step takes a grad function of "
                        "train/steps.py (it carries .batch_weight)")
    if n_accum < 1:
        raise ValueError(f"n_accum must be >= 1, got {n_accum}")
    if not isinstance(state, ShardedTrainState) or state.mesh is not mesh:
        raise TypeError("shard the state onto this mesh first "
                        "(shard_train_state)")
    module = state.module
    for name, p in module.named_parameters():
        if layout_for(name, state.layouts[name].shape, rules,
                      mesh) != state.layouts[name]:
            raise ValueError(f"{name} is laid out {state.layouts[name]}, "
                             "not by these rules")
    seq = shard_sequence and axis_size(mesh, "sp") > 1
    chunked = getattr(getattr(module, "cfg", None), "impl", None) in (
        "ring", "ulysses")
    if seq and not chunked:
        raise ValueError("a sequence split over sp needs an LM step and "
                         "impl='ring' or 'ulysses' attention")
    if chunked and axis_size(mesh, "sp") > 1 and not seq:
        # Such a model takes each process's chunk of the sequence.
        raise ValueError("impl='ring' or 'ulysses' over sp > 1 needs "
                         "shard_sequence=True")
    n_data = math.prod(axis_size(mesh, a) for a in data_axes(mesh))
    if state.batch_stats and n_data > 1:
        raise NotImplementedError(
            "batch statistics over a data-parallel mesh are not ported to "
            "the sharded step; see ROADMAP.md")
    reduce_axes = data_axes(mesh) + (("sp",) if seq else ())
    plans = {name: _plan(module, name, state.layouts[name], reduce_axes)
             for name in state.layouts}
    kw = ({"sequence": (axis_index(mesh, "sp"), axis_size(mesh, "sp"))}
          if seq else {})

    def sharded_step(state: ShardedTrainState, batch):
        with global_mesh(mesh):
            params = _gathered(state, plans)
            total, seen = {}, []
            for micro in split_microbatches(batch, n_accum):
                weight = grad_fn.batch_weight(micro, **kw)
                share = weight / reduce_sum(weight, mesh,
                                            reduce_axes).clamp(min=1.0)
                grads, metrics = grad_fn(state, micro, params=params,
                                         scale=share, **kw)
                for name, p in state.module.named_parameters():
                    g = grads[name].to(p.dtype)
                    total[name] = total[name] + g if name in total else g
                seen.append({k: reduce_sum(v * share, mesh, reduce_axes)
                             for k, v in metrics.items()})
            if n_accum > 1:
                total = {k: g / n_accum for k, g in total.items()}
            state.apply_gradients(_reduce_grads(state, plans, total))
        return state, {k: torch.stack([m[k] for m in seen]).mean()
                       for k in seen[0]}

    return sharded_step, batch_sharding(mesh, seq_axis=shard_sequence)
