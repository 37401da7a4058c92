"""Ops of the port: plain PyTorch versions and the CUDA kernels that
replace the JAX package's Pallas TPU kernels, behind one ``impl`` route."""
from kubeflow_tpu_torch.ops.attention import (  # noqa: F401
    decode_attention,
    dot_product_attention,
    plain_attention,
    plain_decode,
)
from kubeflow_tpu_torch.ops.norms import plain_rms_norm, rms_norm  # noqa: F401
