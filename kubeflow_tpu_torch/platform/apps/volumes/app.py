"""Volumes web app (VWA): PVC CRUD + which pods mount each claim.

The port's copy of ``kubeflow_tpu/platform/apps/volumes/app.py``, which
mirrors the reference VWA backend (reference volumes/backend/apps/common/
form.py:4-39 pvc_from_dict + storage-class sentinel, routes under
apps/common/routes/).
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    POD,
    PVC,
    STORAGECLASS,
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

# The frontend sends this sentinel for "use the cluster default class"
# (reference form.py:4-19).
DEFAULT_STORAGE_CLASS = "{none}"


def pvc_from_dict(body: dict, namespace: str) -> dict:
    pvc = {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {"name": body.get("name", ""), "namespace": namespace},
        "spec": {
            "accessModes": [body.get("mode", "ReadWriteOnce")],
            "resources": {"requests": {"storage": body.get("size", "10Gi")}},
        },
    }
    sc = body.get("class", DEFAULT_STORAGE_CLASS)
    if sc != DEFAULT_STORAGE_CLASS:
        pvc["spec"]["storageClassName"] = sc
    return pvc


def create_app(client, *, auth=None, secure_cookies: Optional[bool] = None,
               caches: Optional[dict] = None) -> App:
    """``caches`` ({GVK: started Informer}, optional): PVC/pod/event reads
    come from the shared informer caches as zero-copy frozen views; every
    handler below is read-only over them, and writes still hit the
    client."""
    app = App("volumes-web-app")
    backend = CrudBackend(client, auth, caches=caches)
    install_standard_middleware(app, backend, secure_cookies=secure_cookies)
    from kubeflow_tpu_torch.platform.web.static_serving import install_frontend

    install_frontend(app, "volumes")

    @app.route("/api/namespaces/<ns>/pvcs")
    def list_pvcs(request: Request, ns: str):
        user = current_user(request)
        pvcs = backend.list_resources(user, PVC, ns)
        pods = backend.list_resources(user, POD, ns)
        out = []
        for pvc in pvcs:
            mounted_by = _pods_using(pods, name_of(pvc))
            out.append({
                "name": name_of(pvc),
                "namespace": ns,
                "status": deep_get(pvc, "status", "phase", default="Pending"),
                "age": deep_get(pvc, "metadata", "creationTimestamp", default=""),
                "capacity": deep_get(
                    pvc, "spec", "resources", "requests", "storage", default=""
                ),
                "modes": deep_get(pvc, "spec", "accessModes", default=[]),
                "class": deep_get(pvc, "spec", "storageClassName", default=""),
                "usedBy": mounted_by,
                "viewer": "none",
            })
        return success({"pvcs": out})

    @app.route("/api/namespaces/<ns>/pvcs", methods=["POST"])
    def post_pvc(request: Request, ns: str):
        user = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        if not body.get("name"):
            raise HttpError(400, "name is required")
        created = backend.create_resource(user, pvc_from_dict(body, ns))
        return success({"pvc": created})

    @app.route("/api/namespaces/<ns>/pvcs/<name>", methods=["DELETE"])
    def delete_pvc(request: Request, ns: str, name: str):
        user = current_user(request)
        pods = backend.list_resources(user, POD, ns)
        used_by = _pods_using(pods, name)
        if used_by:
            raise HttpError(
                409, f"PVC {name} is mounted by pods: {', '.join(used_by)}"
            )
        backend.delete_resource(user, PVC, name, ns)
        return success()

    @app.route("/api/storageclasses")
    def list_storage_classes(request: Request):
        user = current_user(request)
        classes = backend.list_resources(user, STORAGECLASS)
        return success({"storageClasses": [name_of(c) for c in classes]})

    @app.route("/api/namespaces/<ns>/pvcs/<name>")
    def get_pvc(request: Request, ns: str, name: str):
        """Single PVC (reference volumes get.py:19-22)."""
        user = current_user(request)
        return success({"pvc": backend.get_resource(user, PVC, name, ns)})

    @app.route("/api/namespaces/<ns>/pvcs/<name>/pods")
    def pvc_pods(request: Request, ns: str, name: str):
        """Pods mounting the PVC, with phase + mount path — what the
        volume-details page tables (reference volume-details-page)."""
        user = current_user(request)
        out = []
        for pod, vol in _pods_mounting(
            backend.list_resources(user, POD, ns), name
        ):
            mount = ""
            for c in deep_get(pod, "spec", "containers", default=[]) or []:
                for m in c.get("volumeMounts") or []:
                    if m.get("name") == vol.get("name"):
                        mount = m.get("mountPath", "")
                        break
                if mount:
                    break
            out.append({
                "name": name_of(pod),
                "phase": deep_get(pod, "status", "phase", default="Pending"),
                "mountPath": mount,
            })
        return success({"pods": out})

    @app.route("/api/namespaces/<ns>/pvcs/<name>/events")
    def pvc_events(request: Request, ns: str, name: str):
        """Events involving one PVC (reference volumes get.py:32-35)."""
        user = current_user(request)
        events = [
            ev for ev in backend.list_resources(user, EVENT, ns)
            if deep_get(ev, "involvedObject", "name", default="") == name
            and deep_get(ev, "involvedObject", "kind", default="") in (
                "PersistentVolumeClaim", "",
            )
        ]
        return success({"events": events})

    return app


def _pods_mounting(pods, claim: str):
    """(pod, volume) pairs for pods whose spec references ``claim`` — the
    single claim-matching traversal both the list and details views use."""
    for pod in pods:
        for vol in deep_get(pod, "spec", "volumes", default=[]) or []:
            if deep_get(vol, "persistentVolumeClaim", "claimName") == claim:
                yield pod, vol
                break


def _pods_using(pods, claim: str):
    return [name_of(pod) for pod, _vol in _pods_mounting(pods, claim)]
