"""Kubernetes helpers: unstructured objects and the GVK table
(``types.py``), the API's errors (``errors.py``), the quota math
(``quota.py``), the wire codec (``codec.py``) and the REST client with
its circuit breaker (``client.py``)."""

from kubeflow_tpu_torch.platform.k8s import codec
from kubeflow_tpu_torch.platform.k8s.client import (
    CircuitBreaker,
    RestKubeClient,
)

__all__ = ["CircuitBreaker", "RestKubeClient", "codec"]
