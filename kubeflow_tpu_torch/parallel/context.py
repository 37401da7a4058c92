"""The process's active mesh, so leaf ops (ring and Ulysses attention,
the tensor-parallel regions of ``models/layers.py``) and the data loader
find it without threading it through every signature.  Counterpart of
``kubeflow_tpu/parallel/context.py``."""
from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

_CURRENT_MESH: Optional["DeviceMesh"] = None


def set_global_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_global_mesh() -> Optional[DeviceMesh]:
    return _CURRENT_MESH


@contextlib.contextmanager
def global_mesh(mesh: Optional[DeviceMesh]):
    prev = get_global_mesh()
    set_global_mesh(mesh)
    try:
        yield mesh
    finally:
        set_global_mesh(prev)


def sequence_offset(s_local: int) -> int:
    """The global position of this rank's first token when the sequence
    is split into chunks of ``s_local`` over the active mesh's ``sp``
    axis (0 without a mesh)."""
    mesh = get_global_mesh()
    if mesh is None:
        return 0
    return mesh.get_local_rank("sp") * s_local
