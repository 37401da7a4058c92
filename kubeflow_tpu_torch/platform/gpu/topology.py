"""GPU accelerator table and slice math: what a GPU slice asks of the
scheduler.

Counterpart of the reference's ``kubeflow_tpu/platform/tpu/topology.py``
with chips read as GPUs.  A slice of ``gpus`` GPUs spans whole hosts once
it outgrows one, and scheduling it means:

* per-pod GPU limits  (``nvidia.com/gpu: gpus_per_pod``)
* a node selector     (``nvidia.com/gpu.product``, the label NVIDIA's GPU
                       feature discovery writes on each GPU node; a
                       job's pods also select ``nvidia.com/gpu.count``,
                       the node pool the job queue charges them to)
* replica count       (one pod per host, StatefulSet ordinal = worker id)
* worker env          (``parallel/envspec.py`` ``gpu_bootstrap_env``)

A GPU host has no ICI topology: a slice is a count of GPUs, where a TPU
slice is a topology such as ``4x8``.  ``num_slices > 1`` keeps the
reference's meaning, identical slices joined over the data-center
network.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

RESOURCE_GPU = "nvidia.com/gpu"
LABEL_GPU_PRODUCT = "nvidia.com/gpu.product"
# The node's GPU count, written by the same feature discovery.
LABEL_GPU_COUNT = "nvidia.com/gpu.count"


@dataclasses.dataclass(frozen=True)
class GpuAccelerator:
    """One GPU model as the scheduler sees it."""

    name: str              # short name used in specs ("h100-80gb")
    product: str           # the node label's value
    gpus_per_host: int     # GPUs a single host exposes (max per pod)
    hbm_gb_per_gpu: int    # surfaced in the spawner UI


ACCELERATORS: Dict[str, GpuAccelerator] = {
    "h100-80gb": GpuAccelerator("h100-80gb", "NVIDIA-H100-80GB-HBM3", 8, 80),
}


@dataclasses.dataclass(frozen=True)
class GpuSliceSpec:
    """Everything the scheduler-facing side needs to place one slice
    group.  GPU and host fields are per slice; ``total_*`` aggregate
    across slices."""

    accelerator: GpuAccelerator
    gpus: int
    num_hosts: int
    gpus_per_pod: int
    num_slices: int = 1

    @property
    def multi_host(self) -> bool:
        return self.total_hosts > 1

    @property
    def multi_slice(self) -> bool:
        return self.num_slices > 1

    @property
    def total_hosts(self) -> int:
        return self.num_hosts * self.num_slices

    @property
    def total_gpus(self) -> int:
        return self.gpus * self.num_slices

    def node_selectors(self) -> Dict[str, str]:
        return {LABEL_GPU_PRODUCT: self.accelerator.product}

    @property
    def pool(self) -> Tuple[str, int]:
        """``(product, GPUs a node)``: the node pool a job's pods run in,
        one pod a node taking all of its GPUs (``gpu_pool_hosts``), as a
        TPU slice runs in the node pool of its topology."""
        return (self.accelerator.product, self.gpus_per_pod)

    def pool_selectors(self) -> Dict[str, str]:
        """The node selector of a job's pods: the nodes of ``pool``."""
        return {LABEL_GPU_PRODUCT: self.accelerator.product,
                LABEL_GPU_COUNT: str(self.gpus_per_pod)}

    def pod_resources(self) -> Dict[str, str]:
        return {RESOURCE_GPU: str(self.gpus_per_pod)}


def slice_spec(accelerator: str, gpus: Optional[int] = None,
               slices: Optional[int] = None) -> GpuSliceSpec:
    """Resolve (accelerator, gpus[, slices]) -> GpuSliceSpec, validating.
    The default is one full host.  Memoized, as the reference's: the
    result is frozen and the resolution pure."""
    if slices is None:
        slices = 1
    try:
        slices = int(slices)
    except (TypeError, ValueError):
        raise ValueError(f"invalid GPU slice count {slices!r}") from None
    if slices < 1:
        raise ValueError(f"invalid GPU slice count {slices}")
    if not isinstance(accelerator, str):
        raise ValueError(f"invalid GPU accelerator {accelerator!r}")
    if gpus is not None and (isinstance(gpus, bool)
                             or not isinstance(gpus, int) or gpus < 1):
        raise ValueError(f"invalid GPU count {gpus!r}")
    return _slice_spec_cached(accelerator, gpus, slices)


@functools.lru_cache(maxsize=1024)
def _slice_spec_cached(accelerator: str, gpus: Optional[int],
                       slices: int) -> GpuSliceSpec:
    if accelerator not in ACCELERATORS:
        raise ValueError(f"unknown GPU accelerator {accelerator!r}; known: "
                         f"{sorted(ACCELERATORS)}")
    acc = ACCELERATORS[accelerator]
    gpus = acc.gpus_per_host if gpus is None else gpus
    # A slice larger than a host must fill whole hosts: 12 GPUs over
    # 8-GPU hosts has no host decomposition.
    if gpus > acc.gpus_per_host and gpus % acc.gpus_per_host != 0:
        raise ValueError(f"{gpus} GPUs do not pack into {acc.gpus_per_host}"
                         f"-GPU {acc.name} hosts")
    num_hosts = max(1, math.ceil(gpus / acc.gpus_per_host))
    gpus_per_pod = gpus if num_hosts == 1 else acc.gpus_per_host
    return GpuSliceSpec(accelerator=acc, gpus=gpus, num_hosts=num_hosts,
                        gpus_per_pod=gpus_per_pod, num_slices=slices)


def _node_gpus(node) -> Tuple[Optional[str], Optional[int]]:
    """(product label, GPU capacity) of a node; None where absent or
    malformed."""
    labels = (node.get("metadata") or {}).get("labels") or {}
    cap = ((node.get("status") or {}).get("capacity") or {}).get(RESOURCE_GPU)
    try:
        count = int(cap) if cap else None
    except (TypeError, ValueError):
        count = None
    return labels.get(LABEL_GPU_PRODUCT) or None, count


def gpus_on_nodes(nodes) -> Dict[str, list]:
    """Scan node labels and capacity -> {accelerator short name: [the
    per-node GPU counts present]}, the spawner's picker (the reference's
    ``topologies_on_nodes``).  A node of an unknown product, or without
    a positive GPU capacity, offers nothing."""
    by_product = {a.product: a.name for a in ACCELERATORS.values()}
    out: Dict[str, set] = {}
    for node in nodes:
        product, count = _node_gpus(node)
        if product in by_product and count and count > 0:
            out.setdefault(by_product[product], set()).add(count)
    return {k: sorted(v) for k, v in out.items()}


def gpu_pool_hosts(nodes) -> Dict[Tuple[str, int], int]:
    """{(product, GPUs a node): hosts}: the pools a job queue admits
    against (the reference's ``JobQueue.set_nodes``), keyed by the two
    labels a job's pods select (``GpuSliceSpec.pool_selectors``).  A node
    counts where it has GPU capacity and both labels."""
    out: Dict[Tuple[str, int], int] = {}
    for node in nodes or ():
        product, capacity = _node_gpus(node)
        labels = (node.get("metadata") or {}).get("labels") or {}
        try:
            count = int(labels.get(LABEL_GPU_COUNT) or 0)
        except (TypeError, ValueError):
            count = 0
        if not product or not capacity or count < 1:
            continue
        out[(product, count)] = out.get((product, count), 0) + 1
    return out


def gpu_capacity(nodes) -> int:
    """The GPUs of every node, summed (the dashboard's capacity card)."""
    return sum(int(((node.get("status") or {}).get("capacity") or {})
                   .get(RESOURCE_GPU) or 0) for node in nodes)
