"""Wire client for the /v1/generate contract — counterpart of
``kubeflow_tpu/models/client.py``.  It lives in
``platform/web/generate_client.py`` (standard library only, so the
activator shares it without torch); this module re-exports it."""
from kubeflow_tpu_torch.platform.web.generate_client import (  # noqa: F401
    HEADER_DEADLINE,
    HEADER_PRIORITY,
    HEADER_TENANT,
    GenerateClient,
    GenerateResult,
    _parse,
    full_jitter_backoff,
)
