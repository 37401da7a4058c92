"""KFAM REST service: profiles + contributor bindings.

The port's copy of ``kubeflow_tpu/platform/kfam/app.py``.  Interface
mirrors the reference (reference access-management/kfam/
api_default.go:36-43 → routes /kfam/v1/bindings, /kfam/v1/profiles,
/kfam/v1/role/clusteradmin), including the owner-or-cluster-admin gate
before binding mutations (:104-120), with the RoleBinding informer on
``use_informer``.
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform.kfam.bindings import BindingManager
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
               heartbeat: bool = False, use_informer: bool = False) -> App:
    from kubeflow_tpu_torch.platform.runtime import metrics

    app = App("kfam")
    backend = CrudBackend(client, auth)
    install_standard_middleware(app, backend, secure_cookies=secure_cookies)
    cache = None
    if use_informer:
        from kubeflow_tpu_torch.platform.k8s.types import ROLEBINDING
        from kubeflow_tpu_torch.platform.runtime.informer import Informer

        # 60-min resync, matching the reference's informer cache
        # (api_default.go:94-103).
        cache = Informer(client, ROLEBINDING, resync_period=3600.0).start()
        cache.wait_for_sync(10.0)
    # The RoleBinding informer, for the caller to stop with the app.
    app.config["rolebinding_informer"] = cache
    manager = BindingManager(client, cache=cache)
    if heartbeat:
        metrics.start_heartbeat("kfam")

    def counted(kind: str, fn, *args):
        """request_kf/request_kf_failure around each mutation, same
        monitoring surface as the reference (kfam/monitoring.go)."""
        try:
            result = fn(*args)
        except HttpError:
            raise  # client errors aren't service failures
        except Exception:
            metrics.request_kf_failure.labels(
                component="kfam", kind=kind, severity=metrics.SEVERITY_MAJOR
            ).inc()
            raise
        metrics.request_kf.labels(component="kfam", kind=kind).inc()
        return result

    def _require_admin(user: str, namespace: str) -> None:
        if manager.is_owner(user, namespace) or manager.is_cluster_admin(user):
            return
        raise HttpError(
            403, f"user {user!r} is not the owner of {namespace} nor cluster admin"
        )

    def _parse_binding(body: dict):
        user = (body.get("user") or {}).get("name", "")
        namespace = body.get("referredNamespace", "")
        role_ref = (body.get("roleRef") or {}).get("name", "")
        role = role_ref.removeprefix("kubeflow-")
        if not user or not namespace or not role:
            raise HttpError(400, "user.name, referredNamespace, roleRef.name required")
        return user, namespace, role

    @app.route("/kfam/v1/bindings")
    def get_bindings(request: Request):
        namespace = request.args.get("namespace")
        user = request.args.get("user")
        return success({"bindings": manager.list_bindings(namespace, user)})

    @app.route("/kfam/v1/bindings", methods=["POST"])
    def create_binding(request: Request):
        caller = current_user(request)
        user, namespace, role = _parse_binding(
            request.get_json(force=True, silent=True) or {}
        )
        _require_admin(caller, namespace)

        def create():
            # ValueError is a client error (bad role) → 400 before counted()
            # can misclassify it as a service failure.
            try:
                manager.create_binding(user, namespace, role)
            except ValueError as e:
                raise HttpError(400, str(e)) from None

        counted("binding", create)
        return success()

    @app.route("/kfam/v1/bindings", methods=["DELETE"])
    def delete_binding(request: Request):
        caller = current_user(request)
        user, namespace, role = _parse_binding(
            request.get_json(force=True, silent=True) or {}
        )
        _require_admin(caller, namespace)
        counted("binding", manager.delete_binding, user, namespace, role)
        return success()

    @app.route("/kfam/v1/profiles", methods=["POST"])
    def create_profile(request: Request):
        body = request.get_json(force=True, silent=True) or {}
        name = (body.get("metadata") or {}).get("name", "")
        owner = ((body.get("spec") or {}).get("owner") or {}).get("name", "")
        if not name:
            raise HttpError(400, "metadata.name required")
        caller = current_user(request)
        # Self-registration only, unless cluster admin: without this gate any
        # authenticated user could claim ownership of a profile-less
        # namespace and then grant themselves bindings in it.
        if owner and owner != caller and not manager.is_cluster_admin(caller):
            raise HttpError(
                403, "only cluster admins may create profiles for other users"
            )
        counted("profile", manager.create_profile, name, owner or caller)
        return success()

    @app.route("/kfam/v1/profiles/<name>", methods=["DELETE"])
    def delete_profile(request: Request, name: str):
        caller = current_user(request)
        _require_admin(caller, name)
        counted("profile", manager.delete_profile, name)
        return success()

    @app.route("/kfam/v1/role/clusteradmin")
    def cluster_admin(request: Request):
        user = request.args.get("user") or current_user(request)
        return success({"user": user, "isClusterAdmin": manager.is_cluster_admin(user)})

    return app
