"""Partition rules: parameter name -> which mesh axis shards which tensor
dimension; and the tensor-parallel regions the models run in.

Counterpart of ``kubeflow_tpu/parallel/sharding.py``, over the port's
parameter names and its ``[out, in]`` layout.  A spec is a tuple with one
entry a tensor dimension: the mesh axis that shards it, or None.  Every
reference spec shards the same logical axis on the same mesh axis here:
the reference's q_proj ``P("fsdp", "tp", None)`` on (dim, heads,
head_dim) is ``("tp", "fsdp")`` on the port's [heads * head_dim, dim].

Llama (Megatron TP on ``tp``, ``fsdp`` sharding parameters and optimizer
state):

| parameter                  | shape          | spec             |
|----------------------------|----------------|------------------|
| embed.embedding            | [vocab, dim]   | ("tp", "fsdp")   |
| attn q/k/v_proj.weight     | [h * hd, dim]  | ("tp", "fsdp")   |
| attn o_proj.weight         | [dim, h * hd]  | ("fsdp", "tp")   |
| mlp gate/up_proj.weight    | [ffn, dim]     | ("tp", "fsdp")   |
| mlp down_proj.weight       | [dim, ffn]     | ("fsdp", "tp")   |
| MoE w_gate/w_up            | [e, dim, ffn]  | ("ep", "fsdp", "tp") |
| MoE w_down                 | [e, ffn, dim]  | ("ep", "tp", "fsdp") |
| norms' scale               | [dim]          | replicated       |
| lm_head.weight             | [vocab, dim]   | ("tp", "fsdp")   |

``parallel/train.py`` keeps each process's shard of every parameter
(``Layout``) and gathers it for the step; a served model keeps its
shards too and gathers each at its use (``shard_for_serving``), but
only over the axes the model does not compute along (``local_axes``).
Every family computes each parameter the rules split over ``tp`` as its
shard, so nothing is gathered over ``tp``: column-parallel q/k/v,
``fc1``, gate/up, ``wi_0``/``wi_1`` and row-parallel o, ``fc2``, down,
``wo`` (a block's ``tp`` collectives are one all-reduce after each
row-parallel product, ``copy_to_tp`` / ``reduce_from_tp``, run by
``models/layers.py``), T5's relative-bias
tables by head, a Mixtral's experts along their ffn columns
(``models/moe.py``: one all-reduce of a layer's combined output), the
embeddings vocabulary-parallel and the heads column-parallel with their
logits gathered (``gather_from_tp``; training's loss takes them
ungathered, ``train/steps.py`` ``VocabParallelNLL``).  A MoE model's
experts are computed as their ``ep`` shards too (``ep_local(name)``):
``models/moe.py`` sends each expert's tokens to the process that holds
it (``expert_all_to_all``).  Only ``fsdp`` splits are gathered whole.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from kubeflow_tpu_torch.parallel.context import get_global_mesh
from kubeflow_tpu_torch.parallel.mesh import axis_index, axis_size

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# The ``[out, in]`` layout flips the reference's (in, out) kernels: a
# column-parallel kernel P("fsdp", "tp") is ("tp", "fsdp") here.
COL, ROW = ("tp", "fsdp"), ("fsdp", "tp")


def llama_rules() -> Rules:
    return (
        (r".*embed.*embedding$", ("tp", "fsdp")),
        (r".*(w_gate|w_up)$", ("ep", "fsdp", "tp")),
        (r".*w_down$", ("ep", "tp", "fsdp")),
        (r".*router.*weight$", (None, "fsdp")),
        (r".*(q_proj|k_proj|v_proj).*weight$", COL),
        (r".*o_proj.*weight$", ROW),
        (r".*(gate_proj|up_proj).*weight$", COL),
        (r".*down_proj.*weight$", ROW),
        (r".*lm_head.*weight$", COL),
        (r".*", ()),
    )


def vit_rules() -> Rules:
    return (
        (r".*(q_proj|k_proj|v_proj).*weight$", COL),
        (r".*o_proj.*weight$", ROW),
        (r".*fc1.*weight$", COL),
        (r".*fc2.*weight$", ROW),
        (r".*head.*weight$", COL),
        (r".*", ()),
    )


def t5_rules() -> Rules:
    return (
        (r".*embed.*embedding$", ("tp", "fsdp")),
        (r".*(q_proj|k_proj|v_proj).*weight$", COL),
        (r".*o_proj.*weight$", ROW),
        (r".*(wi_0|wi_1).*weight$", COL),
        (r".*\.wo\.weight$", ROW),
        (r".*lm_head.*weight$", COL),
        # The per-head relative-bias tables follow the heads' split.
        (r".*rel_embedding$", (None, "tp")),
        (r".*", ()),
    )


def bert_rules() -> Rules:
    return (
        (r".*(tok_embed|pos_embed).*embedding$", ("tp", "fsdp")),
        # The segment-type table has 2 rows: its vocabulary stays whole.
        (r".*type_embed.*embedding$", (None, "fsdp")),
        (r".*(q_proj|k_proj|v_proj).*weight$", COL),
        (r".*o_proj.*weight$", ROW),
        (r".*fc1.*weight$", COL),
        (r".*fc2.*weight$", ROW),
        (r".*(pooler|classifier).*weight$", (None, "fsdp")),
        (r".*", ()),
    )


def resnet_rules() -> Rules:
    # Only the head is sharded; convolutions and norms replicate.
    return (
        (r".*head.*weight$", COL),
        (r".*", ()),
    )


RULES = {"Llama": llama_rules, "ViT": vit_rules, "ResNet": resnet_rules,
         "T5": t5_rules, "Bert": bert_rules}


def rules_for_model(model) -> Rules:
    """The rules of a model's family; an unknown family raises (a silent
    catch-all would replicate every weight)."""
    name = type(model).__name__
    if name not in RULES:
        raise ValueError(
            f"no partition rules registered for model family {name!r}; "
            f"known: {sorted(RULES)}")
    return RULES[name]()


def spec_for_path(name: str, rules: Rules) -> Spec:
    """The spec of the first rule whose pattern matches ``name`` whole."""
    for pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return tuple(spec)
    return ()


def spec_for_param(name: str, rules: Rules, ndim: int) -> Spec:
    """``spec_for_path`` trimmed or padded with None to ``ndim``."""
    spec = list(spec_for_path(name, rules))[:ndim]
    return tuple(spec + [None] * (ndim - len(spec)))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a parameter lives: its full ``shape`` and the ``(axis, dim)``
    pairs of the mesh axes that shard it (each process holds the chunk
    at its coordinate along each, ``torch.chunk`` order)."""

    shape: tuple
    shards: tuple

    def axis_dim(self, axis: str) -> Optional[int]:
        return next((d for a, d in self.shards if a == axis), None)


def layout_for(name: str, shape, rules: Rules, mesh) -> Layout:
    """The layout of parameter ``name`` by the rules.  A dimension its
    axis does not divide raises ``ValueError``, as the reference's
    placement does."""
    shards = []
    for dim, axis in enumerate(spec_for_param(name, rules, len(shape))):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if shape[dim] % n:
            raise ValueError(
                f"{name}: dimension {dim} of {tuple(shape)} does not divide "
                f"over mesh axis {axis!r} of size {n}")
        if n > 1:
            shards.append((axis, dim))
    return Layout(tuple(shape), tuple(shards))


def local_shard(full: torch.Tensor, layout: Layout, mesh) -> torch.Tensor:
    """This process's chunk of a full tensor (a copy, contiguous)."""
    for axis, dim in layout.shards:
        full = full.chunk(axis_size(mesh, axis), dim=dim)[
            axis_index(mesh, axis)]
    return full.contiguous().clone()


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The chunks of ``group``'s processes joined along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return torch.cat(out.chunk(n), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group``, each process keeping its chunk along
    ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    inp = torch.cat([c.contiguous() for c in x.chunk(n, dim=dim)])
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor)."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def data_axes(mesh) -> tuple:
    """The axes the batch dimension shards over: dp, fsdp and ep (ep is a
    data axis outside MoE layers)."""
    return tuple(a for a in ("dp", "fsdp", "ep") if a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This process's part of a global batch: rows ``index`` of ``count``
    equal parts over the data axes, and with ``seq_axis`` sequence chunk
    ``seq_index`` of ``seq_count`` over ``sp``.  Processes that differ
    only on other axes hold the same part."""

    index: int
    count: int
    seq_index: int = 0
    seq_count: int = 1


def data_coordinates(mesh) -> tuple:
    """``(index, count)`` of this process over the data axes, row-major
    (dp outermost), the reference's process order."""
    index, count = 0, 1
    for axis in data_axes(mesh):
        n = axis_size(mesh, axis)
        index, count = index * n + axis_index(mesh, axis), count * n
    return index, count


def data_groups(mesh) -> tuple:
    """The process groups of the data axes longer than 1, innermost first
    (ep, fsdp, dp): gathering over them in this order joins the chunks in
    ``data_coordinates`` order."""
    if mesh is None:
        return ()
    return tuple(mesh.get_group(a) for a in reversed(data_axes(mesh))
                 if axis_size(mesh, a) > 1)


def gather_data(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The processes' chunks along ``dim`` joined over the data axes, in
    ``data_coordinates`` order (``x`` itself without a data axis)."""
    for group in data_groups(mesh):
        x = all_gather_dim(x, group, dim)
    return x


def page_pool_shards(mesh) -> int:
    """How many shards the paged-KV pool's position axis splits into on
    ``mesh``: the product of the data-axis sizes (1 without a mesh; the
    ``tp`` and ``sp`` axes never split the pool, the K/V heads already
    split over ``tp`` inside each position).  The reference's
    ``page_pool_shards``."""
    if mesh is None:
        return 1
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def page_pool_spec(mesh, pool_positions: int) -> tuple:
    """``(first, count)``: the pool positions this process owns, the
    contiguous block at its data coordinate (the reference's
    ``page_pool_spec`` shards the same axis over the same axes).  The
    paged engine rounds its pages up to a multiple of
    ``page_pool_shards``, so a page never straddles two processes."""
    index, count = data_coordinates(mesh) if mesh is not None else (0, 1)
    if pool_positions % count:
        raise ValueError(f"{pool_positions} pool positions do not divide "
                         f"over {count} data shards")
    n = pool_positions // count
    return index * n, n


def batch_sharding(mesh, *, seq_axis: bool = False) -> BatchSharding:
    """Batch rows over the data axes; with ``seq_axis`` the sequence over
    ``sp`` too."""
    index, count = data_coordinates(mesh)
    if not seq_axis:
        return BatchSharding(index, count)
    return BatchSharding(index, count, axis_index(mesh, "sp"),
                         axis_size(mesh, "sp"))


def shard_params(module: torch.nn.Module, mesh, rules: Rules) -> dict:
    """Replace every parameter of ``module`` by this process's shard of it
    under the rules (every process builds the module with the same
    values).  Returns ``{name: Layout}``; the module then runs only
    through a step that gathers its parameters (``parallel/train.py``)."""
    layouts = {}
    for mod_name, mod in module.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            layout = layout_for(name, p.shape, rules, mesh)
            layouts[name] = layout
            if layout.shards:
                setattr(mod, pname, torch.nn.Parameter(
                    local_shard(p.detach(), layout, mesh),
                    requires_grad=p.requires_grad))
    return layouts


def local_axes(module: torch.nn.Module, name: str) -> tuple:
    """The mesh axes along which ``module`` computes with its shard of
    parameter ``name``: ``tp`` for every parameter (every family computes
    its ``tp`` splits as shards), and ``ep`` for a MoE model's
    ``ep_local`` experts; every other axis of the parameter's layout is
    gathered at use."""
    ep_local = getattr(module, "ep_local", None)
    return ("tp", "ep") if ep_local is not None and ep_local(name) \
        else ("tp",)


class GatherAtUse(nn.Module):
    """A parametrization that joins a parameter's shards over ``steps``
    (``(group, dim)`` pairs) each time the parameter is read: the module
    stores its shard, and the whole (or its computed shard) exists only
    while a call uses it.  Every process reads its parameters in the same
    order, so the gathers pair up."""

    def __init__(self, steps):
        super().__init__()
        self.steps = tuple(steps)

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        for group, dim in self.steps:
            shard = all_gather_dim(shard, group, dim)
        return shard


def stored(module: torch.nn.Module, name: str) -> Optional[torch.Tensor]:
    """The tensor ``module`` stores as ``name``: its shard when the
    parameter is gathered at use (read without gathering it)."""
    if parametrize.is_parametrized(module, name):
        return module.parametrizations[name].original
    return getattr(module, name)


def _source_shard(src: torch.Tensor, layout: Layout, mesh) -> torch.Tensor:
    """A source tensor (whole, or already this process's slice) -> this
    process's slice.  Slicing a memory-mapped tensor reads the slice."""
    if tuple(src.shape) == layout.shape:
        return local_shard(src, layout, mesh)
    want = list(layout.shape)
    for axis, dim in layout.shards:
        want[dim] //= axis_size(mesh, axis)
    if list(src.shape) != want:
        raise ValueError(f"source shape {tuple(src.shape)} is neither the "
                         f"whole {layout.shape} nor this process's {want}")
    return src


def shard_for_serving(model: torch.nn.Module, mesh, rules: Rules, *,
                      device, seed: Optional[int] = None,
                      source: Optional[dict] = None) -> dict:
    """Give ``model``, built on the ``meta`` device, this process's shards
    of its parameters on ``device``, without the whole model on any
    device: module by module (the order ``reset_parameters`` walks),
    the module's parameters are drawn whole from a generator seeded with
    ``seed`` (so the values are those of an unsharded model drawn from
    the same seed), or taken from ``source`` (name -> the whole tensor,
    e.g. memory-mapped from a checkpoint, or this process's slice), and
    only this process's slice is kept.  A parameter sharded over an axis
    the model does not compute along (``local_axes``) is gathered at
    each use (``GatherAtUse``).  Returns ``{name: Layout}``."""
    if (seed is None) == (source is None):
        raise ValueError("give exactly one of seed and source")
    gen = (torch.Generator(device=device).manual_seed(seed)
           if source is None else None)
    names = {id(m): n for n, m in model.named_modules()}
    layouts = {}
    for mod in list(model.modules()):
        own = list(mod.named_parameters(recurse=False))
        if not own:
            continue
        prefix = names[id(mod)]
        if source is None:
            mod.to_empty(device=device, recurse=False)
            if mod is not model and hasattr(mod, "reset_parameters"):
                with torch.no_grad():
                    mod.reset_parameters(gen)
            own = list(mod.named_parameters(recurse=False))
        for pname, p in own:
            name = f"{prefix}.{pname}" if prefix else pname
            layout = layout_for(name, p.shape, rules, mesh)
            if source is None:
                local = local_shard(p.detach(), layout, mesh)
            else:
                local = _source_shard(source[name], layout, mesh).to(
                    device=device, dtype=p.dtype).contiguous()
            setattr(mod, pname, nn.Parameter(local, requires_grad=False))
            keep = local_axes(model, name)
            steps = [(mesh.get_group(a), d) for a, d in layout.shards
                     if a not in keep]
            if steps:
                parametrize.register_parametrization(
                    mod, pname, GatherAtUse(steps), unsafe=True)
            layouts[name] = layout
    if source is not None:
        extra = sorted(set(source) - set(layouts))
        if extra:
            raise KeyError(f"source has parameters the model lacks: {extra}")
    return layouts


def infer_state_shardings(module: torch.nn.Module, mesh, rules: Rules
                          ) -> dict:
    """Parameter name -> its ``Layout`` by the rules (the optimizer's
    moments follow their parameter's)."""
    return {name: layout_for(name, p.shape, rules, mesh)
            for name, p in module.named_parameters()}


# -- tensor-parallel regions ---------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over
    ``tp`` (each rank's shard of a column-parallel product contributes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward over ``tp`` (a row-parallel product's partial
    sums); identity backward (the sum's cotangent is the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class VirtualGroup:
    """The ``tp`` group of a mesh whose ranks one process runs one after
    another, each as the global mesh in turn: the ``tp`` collectives over
    it (``copy_to_tp``, ``reduce_from_tp``, ``gather_from_tp``,
    ``all_reduce_max``) do nothing, and the caller combines the ranks'
    parts itself (adds their partial sums in rank order, joins their
    outputs)."""


@dataclasses.dataclass(frozen=True)
class TPShard:
    """This process's place on the ``tp`` axis for one parameter it holds
    as a shard: its coordinate ``rank`` of ``size``, and the axis's
    process ``group`` (or a ``VirtualGroup``)."""

    group: Any
    rank: int
    size: int


def tp_shard(weight: Optional[torch.Tensor], full: int,
             dim: int = 0) -> Optional[TPShard]:
    """The ``TPShard`` when ``weight`` holds fewer than the layer's
    ``full`` entries along ``dim`` (it is a ``tp`` shard), else None.  A
    shard that the active mesh's ``tp`` axis does not cut so, or a mesh
    without a ``tp`` group, raises."""
    if weight is None or weight.shape[dim] >= full:
        return None
    mesh = get_global_mesh()
    if mesh is None or axis_size(mesh, "tp") * weight.shape[dim] != full:
        raise RuntimeError(
            f"a weight of {weight.shape[dim]} of {full} entries along dim "
            f"{dim} is a tp shard, but the active mesh's tp axis does not "
            "split it so")
    group = mesh.get_group("tp")
    if group is None:
        raise RuntimeError("the active mesh has no tp process group")
    return TPShard(group, axis_index(mesh, "tp"), axis_size(mesh, "tp"))


def ep_group(local_experts: int, n_experts: int):
    """The ``ep`` process group when a process holds ``local_experts`` of
    a layer's ``n_experts`` (its experts are an ``ep`` shard), else None.
    A shard with no active mesh raises."""
    if local_experts >= n_experts:
        return None
    mesh = get_global_mesh()
    if mesh is None or axis_size(mesh, "ep") * local_experts != n_experts:
        raise RuntimeError(
            f"{local_experts} of {n_experts} experts is an ep shard, but the "
            "active mesh's ep axis does not split them so")
    return mesh.get_group("ep")


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal chunks of dim 0; with equal chunks
    it is its own transpose, so the backward sends the gradient's chunks
    back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def expert_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] expert-major buffers -> the same shape with chunk j of dim
    0 (the experts process j holds) sent to process j, and chunk i of the
    result received from process i."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def _group(tp: Optional[TPShard]):
    """The group to run ``tp``'s collectives over (None: none to run)."""
    if tp is None or isinstance(tp.group, VirtualGroup):
        return None
    return tp.group


def copy_to_tp(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """The input of column-parallel products: identity forward; the
    backward sums the gradient over ``tp``."""
    group = _group(tp)
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """Row-parallel partial sums summed over ``tp`` (identity backward)."""
    group = _group(tp)
    return x if group is None else _ReduceFromTP.apply(x, group)


def tp_slice(t: torch.Tensor, tp: Optional[TPShard],
             dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a tensor every ``tp`` rank holds
    whole (a replicated bias of a column-parallel product): its gradient
    lands on the chunk only, so the backward sums it over ``tp`` and every
    rank gets the whole gradient."""
    if tp is None:
        return t
    return copy_to_tp(t, tp).chunk(tp.size, dim=dim)[tp.rank]


class _GatherFromTP(torch.autograd.Function):
    """All-gather forward over ``tp`` along ``dim`` in rank order (each
    rank's output features); the backward keeps this rank's chunk of the
    gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


def gather_from_tp(x: torch.Tensor, tp: Optional[TPShard],
                   dim: int = -1) -> torch.Tensor:
    """Each ``tp`` rank's chunk along ``dim`` joined in rank order (a
    column-parallel head's logits)."""
    group = _group(tp)
    return x if group is None else _GatherFromTP.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, tp: Optional[TPShard]) -> torch.Tensor:
    """``x``'s elementwise maximum over ``tp`` (no gradient)."""
    group = _group(tp)
    if group is None or dist.get_world_size(group) == 1:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _SumOverGroups(torch.autograd.Function):
    """All-reduce forward over each of ``groups`` in turn; the backward
    all-reduces the gradient the same way (every process's objective
    depends on the sum)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for group in groups:
            x = all_reduce_sum(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = all_reduce_sum(g, group)
        return g, None


def sum_over(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    """``x`` summed over the processes of ``groups`` (e.g. ``data_groups``),
    differentiably: the gradient is summed over them too."""
    return _SumOverGroups.apply(x, tuple(groups)) if groups else x
