"""Device meshes over the reference's axes, as ``torch.distributed``
``DeviceMesh``es.

Counterpart of ``kubeflow_tpu/parallel/mesh.py``.  Axis convention, outer
to inner: ``pp`` (pipeline stages), ``dp`` (pure data parallelism),
``fsdp`` (data parallelism with sharded parameters and optimizer state),
``ep`` (experts; a data axis outside MoE layers), ``tp`` (Megatron
tensor parallelism), ``sp`` (sequence parallelism).  A mesh point is one
process, and one process drives one device, so the mesh is laid over
ranks: ``mesh_ranks`` and ``hybrid_mesh_ranks`` are the pure layouts
(config and world size -> rank array, the reference's device-id arrays),
``make_mesh`` and ``make_hybrid_mesh`` build the ``DeviceMesh`` over them
in an initialized process group (``parallel/dist.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; ``pp`` is outermost (its traffic is neighbour to
    neighbour once a microbatch, the most tolerant of slow links)."""

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.pp * self.dp * self.fsdp * self.ep * self.tp * self.sp

    def axis_sizes(self) -> tuple:
        return (self.pp, self.dp, self.fsdp, self.ep, self.tp, self.sp)


def world_size() -> int:
    """Processes in the group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_config(config: Optional[MeshConfig], n_devices: int,
                   **axis_sizes: int) -> MeshConfig:
    """The config with its one ``-1`` axis inferred from ``n_devices``
    (like a reshape); the reference's checks and messages."""
    if config is None:
        config = MeshConfig(**axis_sizes)
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    sizes = list(config.axis_sizes())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n_devices % known:
            raise ValueError(f"{n_devices} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n_devices // known
    if math.prod(sizes) != n_devices:
        raise ValueError(
            f"mesh {dict(zip(AXIS_NAMES, sizes))} needs {math.prod(sizes)} "
            f"devices, have {n_devices}")
    return MeshConfig(*sizes)


def mesh_ranks(config: MeshConfig, n_devices: int) -> torch.Tensor:
    """The rank at each mesh point: ``arange(n).reshape(sizes)``, the
    reference's ``np.asarray(devices).reshape(sizes)``."""
    config = resolve_config(config, n_devices)
    return torch.arange(n_devices).reshape(config.axis_sizes())


def hybrid_mesh_ranks(ici: MeshConfig, dcn: MeshConfig,
                      n_devices: int) -> torch.Tensor:
    """The multi-slice layout (the reference's fallback, ``mesh.py:127-134``):
    ranks in slice-major contiguous blocks, each named axis of size
    ``dcn_axis * ici_axis`` with the DCN factor outermost within it, so
    only the ``dcn`` axes cross slices."""
    ici_sizes, dcn_sizes = ici.axis_sizes(), dcn.axis_sizes()
    n_slices, per_slice = math.prod(dcn_sizes), math.prod(ici_sizes)
    if n_slices * per_slice != n_devices:
        raise ValueError(
            f"hybrid mesh ici={ici_sizes} x dcn={dcn_sizes} needs "
            f"{n_slices * per_slice} devices, have {n_devices}")
    arr = torch.arange(n_devices).reshape(tuple(dcn_sizes) + tuple(ici_sizes))
    n = len(AXIS_NAMES)
    interleave = [k for i in range(n) for k in (i, i + n)]
    return arr.permute(interleave).reshape(
        [d * i for d, i in zip(dcn_sizes, ici_sizes)])


def _device_mesh(ranks: torch.Tensor, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "a DeviceMesh needs an initialized process group: call "
            "parallel.dist.initialize_from_env() (or init_process_group) "
            "first")
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_NAMES)


def make_mesh(config: Optional[MeshConfig] = None, *,
              device_type: str = "cuda", **axis_sizes: int) -> DeviceMesh:
    """``make_mesh(dp=2, tp=4)`` or ``make_mesh(MeshConfig(...))`` over the
    process group's ranks (one axis may be -1).  A size that does not
    match the world raises ``ValueError`` before any group is touched."""
    ranks = mesh_ranks(resolve_config(config, world_size(), **axis_sizes),
                       world_size())
    return _device_mesh(ranks, device_type)


def make_hybrid_mesh(ici: MeshConfig, dcn: MeshConfig, *,
                     device_type: str = "cuda") -> DeviceMesh:
    """Multi-slice mesh over ``hybrid_mesh_ranks``: ``dcn`` axes span
    slice boundaries (the platform's process ids are slice-major,
    ``dist.process_grid``), ``ici`` axes stay inside a slice."""
    return _device_mesh(hybrid_mesh_ranks(ici, dcn, world_size()),
                        device_type)


def default_mesh_config(n_devices: int) -> MeshConfig:
    """The reference's split for a device count: fsdp takes everything but
    an innermost tp factor of 8, 4 or 2 once at least two remain."""
    if n_devices == 1:
        return MeshConfig()
    tp = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            tp = cand
            break
    if n_devices % tp or n_devices // tp < 1:
        tp = 1
    return MeshConfig(dp=1, fsdp=n_devices // tp, tp=tp, sp=1)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXIS_NAMES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)
