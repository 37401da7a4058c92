"""Model zoo of the port (Llama and Mixtral, ResNet, ViT, BERT, T5) and its
serving stack."""
from kubeflow_tpu_torch.models.registry import (  # noqa: F401
    create_model,
    list_models,
    register_model,
)
