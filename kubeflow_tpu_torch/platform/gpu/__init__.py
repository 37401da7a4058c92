from kubeflow_tpu_torch.platform.gpu.topology import (
    ACCELERATORS,
    LABEL_GPU_COUNT,
    LABEL_GPU_PRODUCT,
    RESOURCE_GPU,
    GpuAccelerator,
    GpuSliceSpec,
    gpu_capacity,
    gpu_pool_hosts,
    gpus_on_nodes,
    slice_spec,
)

__all__ = [
    "ACCELERATORS",
    "LABEL_GPU_COUNT",
    "LABEL_GPU_PRODUCT",
    "RESOURCE_GPU",
    "GpuAccelerator",
    "GpuSliceSpec",
    "gpu_capacity",
    "gpu_pool_hosts",
    "gpus_on_nodes",
    "slice_spec",
]
