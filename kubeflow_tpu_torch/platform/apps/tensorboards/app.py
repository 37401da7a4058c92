"""Tensorboards web app (TWA): Tensorboard CR CRUD.

The port's copy of ``kubeflow_tpu/platform/apps/tensorboards/app.py``,
which mirrors the reference TWA backend (reference tensorboards/backend/
app/routes/post.py:14-38 and friends).
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform.k8s.types import (
    PODDEFAULT,
    PVC,
    TENSORBOARD,
    deep_get,
    name_of,
)
from kubeflow_tpu_torch.platform.web.crud_backend import (
    CrudBackend,
    current_user,
    install_standard_middleware,
)
from kubeflow_tpu_torch.platform.web.framework import (
    App,
    HttpError,
    Request,
    success,
)


def create_app(client, *, auth=None, secure_cookies: Optional[bool] = None,
               caches: Optional[dict] = None) -> App:
    """``caches`` ({GVK: started Informer}, optional): table/picker reads
    come from the shared informer caches as zero-copy frozen views; the
    handlers below are read-only over them."""
    app = App("tensorboards-web-app")
    backend = CrudBackend(client, auth, caches=caches)
    install_standard_middleware(app, backend, secure_cookies=secure_cookies)
    from kubeflow_tpu_torch.platform.web.static_serving import install_frontend

    install_frontend(app, "tensorboards")

    @app.route("/api/namespaces/<ns>/tensorboards")
    def list_tensorboards(request: Request, ns: str):
        user = current_user(request)
        tbs = backend.list_resources(user, TENSORBOARD, ns)
        out = [{
            "name": name_of(tb),
            "namespace": ns,
            "logspath": deep_get(tb, "spec", "logspath", default=""),
            "age": deep_get(tb, "metadata", "creationTimestamp", default=""),
            "ready": bool(deep_get(tb, "status", "readyReplicas", default=0)),
        } for tb in tbs]
        return success({"tensorboards": out})

    @app.route("/api/namespaces/<ns>/tensorboards", methods=["POST"])
    def post_tensorboard(request: Request, ns: str):
        user = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        name = body.get("name", "")
        logspath = body.get("logspath", "")
        if not name or not logspath:
            raise HttpError(400, "name and logspath are required")
        tb = {
            "apiVersion": "tensorboard.kubeflow.org/v1alpha1",
            "kind": "Tensorboard",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"logspath": logspath},
        }
        return success({"tensorboard": backend.create_resource(user, tb)})

    @app.route("/api/namespaces/<ns>/tensorboards/<name>", methods=["DELETE"])
    def delete_tensorboard(request: Request, ns: str, name: str):
        user = current_user(request)
        backend.delete_resource(user, TENSORBOARD, name, ns)
        return success()

    @app.route("/api/namespaces/<ns>/pvcs")
    def list_pvcs(request: Request, ns: str):
        """PVC names for the logspath picker (reference TWA get.py:23-29)."""
        user = current_user(request)
        pvcs = backend.list_resources(user, PVC, ns)
        return success({"pvcs": [name_of(p) for p in pvcs]})

    @app.route("/api/namespaces/<ns>/poddefaults")
    def list_poddefaults(request: Request, ns: str):
        """PodDefaults with form label/desc fields (reference TWA get.py:32-47)."""
        user = current_user(request)
        out = []
        for pd in backend.list_resources(user, PODDEFAULT, ns):
            labels = deep_get(pd, "spec", "selector", "matchLabels", default={}) or {}
            out.append({
                "name": name_of(pd),
                "label": next(iter(labels.keys()), ""),
                "desc": deep_get(pd, "spec", "desc", default=name_of(pd)),
            })
        return success({"poddefaults": out})

    return app
