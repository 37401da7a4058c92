"""Model zoo of the port (dense Llama so far) and its serving stack."""
from kubeflow_tpu_torch.models.registry import (  # noqa: F401
    create_model,
    register_model,
)
