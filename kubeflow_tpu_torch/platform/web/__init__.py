"""The platform's web layer on the standard library: the framework
(``framework.py``), the CRUD backends' shared authn, authz, CSRF, probes
and request counters (``crud_backend.py``), the SPAs' static files
(``static_serving.py``), and the /v1/generate contract's two sides that
the model server and the activator share: the serving app
(``serve_app.py``) and the wire client (``generate_client.py``)."""
from kubeflow_tpu_torch.platform.web.framework import (
    App,
    Blueprint,
    HttpError,
    json_response,
)

__all__ = ["App", "Blueprint", "HttpError", "json_response"]
