"""The platform's web layer on the standard library: the framework
(``framework.py``), the CRUD backends' shared authn, authz, CSRF, probes
and request counters (``crud_backend.py``) and the SPAs' static files
(``static_serving.py``)."""
from kubeflow_tpu_torch.platform.web.framework import (
    App,
    Blueprint,
    HttpError,
    json_response,
)

__all__ = ["App", "Blueprint", "HttpError", "json_response"]
