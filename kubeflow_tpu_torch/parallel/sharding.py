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
(``Layout``) and gathers it for the step.  A model may declare parameters
it computes with as their ``tp`` shards (``tp_local(name)``): Llama's
column-parallel q/k/v, gate and up and row-parallel o and down, so a
block's only ``tp`` collectives are one all-reduce after o_proj and one
after down_proj (``copy_to_tp`` / ``reduce_from_tp``, run by
``models/layers.py``); every other parameter is gathered whole over
``tp`` too.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


def tp_group(weight: Optional[torch.Tensor], full_rows: int):
    """The ``tp`` process group when ``weight`` holds fewer rows than the
    layer's full ``full_rows`` (it is a column-parallel shard), else None.
    A shard with no active mesh raises."""
    if weight is None or weight.shape[0] >= full_rows:
        return None
    mesh = get_global_mesh()
    if mesh is None or axis_size(mesh, "tp") * weight.shape[0] != full_rows:
        raise RuntimeError(
            f"a weight of {weight.shape[0]} of {full_rows} rows is a tp "
            "shard, but the active mesh's tp axis does not split it so")
    return mesh.get_group("tp")


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)
