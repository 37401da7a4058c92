"""Central dashboard backend: the landing API every page load hits.  The
port's copy of ``kubeflow_tpu/platform/dashboard/app.py``, on the port's
``web/framework.py``.

Mirrors the reference Express server's surface (centraldashboard/app/
server.ts:26-95, api.ts:29-103, api_workgroup.ts:40-118): namespaces,
activities (events), dashboard links and settings from a ConfigMap,
env-info with the role mapping, the registration flow (create a
Profile), and contributor management, the KFAM bridge a direct library
call instead of an HTTP hop.

``/api/gpu-overview`` (the reference's ``/api/tpu-overview``) sums the
nodes' ``nvidia.com/gpu`` capacity and each namespace's Notebook GPUs
(``spec.gpu``), and with ``?ns=`` adds the namespace's GPU budget under
the spawner's accounting (``apis/notebook.namespace_gpu_budget``).  Its
keys are ``clusterCapacityGPUs`` and ``requestedGPUsByNamespace``.
"""
from __future__ import annotations

import json
from typing import Optional

from kubeflow_tpu_torch.platform.gpu.topology import gpu_capacity
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    CONFIGMAP,
    EVENT,
    NAMESPACE,
    NODE,
    NOTEBOOK,
    PROFILE,
    deep_get,
    name_of,
)
from kubeflow_tpu_torch.platform.kfam.bindings import BindingManager, _sanitize
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

SETTINGS_CONFIGMAP = "kubeflow-dashboard-settings"
SETTINGS_NAMESPACE = "kubeflow"

ROLE_MAP = {"admin": "owner", "edit": "contributor", "view": "viewer"}


def create_app(client, *, auth=None, secure_cookies: Optional[bool] = None,
               metrics_service=None) -> App:
    app = App("centraldashboard")
    backend = CrudBackend(client, auth)
    install_standard_middleware(app, backend, secure_cookies=secure_cookies)
    from kubeflow_tpu_torch.platform.web.static_serving import install_frontend

    install_frontend(app, "dashboard")
    manager = BindingManager(client)

    # -- /api ------------------------------------------------------------------

    @app.route("/api/namespaces")
    def namespaces(request: Request):
        user = current_user(request)
        out = [name_of(ns) for ns in backend.list_resources(user, NAMESPACE)]
        return success({"namespaces": out})

    @app.route("/api/activities/<ns>")
    def activities(request: Request, ns: str):
        user = current_user(request)
        events = backend.list_resources(user, EVENT, ns)
        events.sort(key=lambda e: e.get("lastTimestamp", ""), reverse=True)
        return success({"events": events[:100]})

    @app.route("/api/dashboard-links")
    def dashboard_links(request: Request):
        return success({"links": _settings(client).get("links", {
            "menuLinks": [
                {"link": "/jupyter/", "text": "Notebooks", "icon": "book"},
                {"link": "/volumes/", "text": "Volumes", "icon": "device:storage"},
                {"link": "/tensorboards/", "text": "TensorBoards",
                 "icon": "assessment"},
            ],
            "externalLinks": [],
            "quickLinks": [
                {"desc": "Create a new Notebook server",
                 "link": "/jupyter/new"},
            ],
        })})

    @app.route("/api/dashboard-settings")
    def dashboard_settings(request: Request):
        return success({"settings": _settings(client).get("settings", {
            "DASHBOARD_FORCE_IFRAME": True,
        })})

    @app.route("/api/metrics/<mtype>")
    def get_metrics(request: Request, mtype: str):
        """Utilization time series (reference api.ts:29-58): 405 when no
        metrics service is wired, ?interval=Last15m windows otherwise."""
        from kubeflow_tpu_torch.platform.dashboard.metrics_service import Interval

        if metrics_service is None:
            raise HttpError(405, "metrics service not configured")
        interval = Interval.parse(request.args.get("interval"))
        fetchers = {
            "node": metrics_service.node_cpu_utilization,
            "podcpu": metrics_service.pod_cpu_utilization,
            "podmem": metrics_service.pod_memory_usage,
            "gpu": metrics_service.gpu_duty_cycle,
            "reconcile": metrics_service.reconcile_latency,
            "workqueue": metrics_service.workqueue_depth,
        }
        fn = fetchers.get(mtype)
        if fn is None:
            raise HttpError(404, f"unknown metrics type {mtype!r}")
        try:
            points = fn(interval)
        except NotImplementedError:
            # 501, not 405: the service is wired and this one type is not
            # supported by it; the SPA hides the whole card only on the
            # nothing-configured 405 above.
            raise HttpError(
                501, f"metrics type {mtype!r} not supported by this service"
            ) from None
        return success({"points": [p.to_dict() for p in points]})

    @app.route("/api/gpu-overview")
    def gpu_overview(request: Request):
        from kubeflow_tpu_torch.platform.apis.notebook import (
            gpu_slice_or_none,
            namespace_gpu_budget,
        )

        user = current_user(request)
        capacity = gpu_capacity(backend.list_resources(user, NODE))
        requested = {}
        for ns in backend.list_resources(user, NAMESPACE):
            ns_name = name_of(ns)
            try:
                notebooks = client.list(NOTEBOOK, ns_name)
            except errors.ApiError:
                continue
            total = 0
            for nb in notebooks:
                s = gpu_slice_or_none(nb)
                if s:
                    total += s.total_gpus
            if total:
                requested[ns_name] = total
        out = {
            "clusterCapacityGPUs": capacity,
            "requestedGPUsByNamespace": requested,
        }
        # The namespace's GPU budget for the home card (?ns=...), under
        # the spawner's accounting and read with the app's own client: it
        # is what quota admission will do, whether or not the user may
        # list ResourceQuota objects.
        ns = request.args.get("ns")
        if ns:
            try:
                out["quota"] = namespace_gpu_budget(client, ns)
            except errors.ApiError:
                out["quota"] = None
        return success(out)

    # -- /api/workgroup --------------------------------------------------------

    @app.route("/api/workgroup/env-info")
    def env_info(request: Request):
        user = current_user(request)
        profiles = {name_of(p): p for p in client.list(PROFILE)}
        namespaces = []
        for binding in manager.list_bindings(user=user):
            role = binding["roleRef"]["name"].removeprefix("kubeflow-")
            namespaces.append({
                "namespace": binding["referredNamespace"],
                "role": ROLE_MAP.get(role, role),
                "user": user,
            })
        owned = [
            name_of(p) for p in profiles.values()
            if deep_get(p, "spec", "owner", "name") == user
        ]
        for ns in owned:
            if not any(n["namespace"] == ns for n in namespaces):
                namespaces.append({"namespace": ns, "role": "owner", "user": user})
        return success({
            "user": user,
            "platform": {"kubeflowVersion": "gpu-native-0.1.0"},
            "hasWorkgroup": bool(owned),
            "hasAuth": not backend.auth.disable_auth,
            "namespaces": namespaces,
            "isClusterAdmin": manager.is_cluster_admin(user),
        })

    @app.route("/api/workgroup/create", methods=["POST"])
    def workgroup_create(request: Request):
        user = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        requested = body.get("namespace")
        default = _default_namespace(user)
        # Self-registration claims only the user's own derived namespace;
        # arbitrary namespace names need cluster admin (same hole as KFAM
        # profile creation otherwise).
        if requested and requested != default and not manager.is_cluster_admin(user):
            raise HttpError(
                403, f"only cluster admins may register namespace {requested!r}"
            )
        name = requested or default
        try:
            manager.create_profile(name, user)
        except errors.Conflict:
            raise HttpError(409, f"namespace {name} already exists") from None
        return success({"namespace": name})

    @app.route("/api/workgroup/nuke-self", methods=["DELETE"])
    def workgroup_nuke(request: Request):
        user = current_user(request)
        victims = [
            name_of(p) for p in client.list(PROFILE)
            if deep_get(p, "spec", "owner", "name") == user
        ]
        for name in victims:
            manager.delete_profile(name)
        return success({"deleted": victims})

    @app.route("/api/workgroup/contributors/<ns>")
    def list_contributors(request: Request, ns: str):
        """All bindings for a namespace (owner + contributors) — what the
        manage-contributors view renders (reference api_workgroup.ts binding
        mapping :63-100 reads the namespace's bindings, not the caller's)."""
        caller = current_user(request)
        if not (manager.is_owner(caller, ns) or manager.is_cluster_admin(caller)
                or any(b["referredNamespace"] == ns
                       for b in manager.list_bindings(user=caller))):
            raise HttpError(403, f"no access to namespace {ns!r}")
        out = []
        profile_owner = None
        try:
            profile = client.get(PROFILE, ns)
            profile_owner = deep_get(profile, "spec", "owner", "name")
        except errors.ApiError:
            pass
        if profile_owner:
            out.append({"user": profile_owner, "role": "owner"})
        for binding in manager.list_bindings(namespace=ns):
            role = binding["roleRef"]["name"].removeprefix("kubeflow-")
            bound = binding["user"]["name"]
            if bound == profile_owner:
                continue
            out.append({"user": bound, "role": ROLE_MAP.get(role, role)})
        return success({"contributors": out})

    @app.route("/api/workgroup/add-contributor", methods=["POST"])
    def add_contributor(request: Request):
        caller = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        contributor = body.get("contributor", "")
        namespace = body.get("namespace", "")
        if not contributor or not namespace:
            raise HttpError(400, "contributor and namespace required")
        if not (manager.is_owner(caller, namespace)
                or manager.is_cluster_admin(caller)):
            raise HttpError(403, "only the namespace owner may add contributors")
        manager.create_binding(contributor, namespace, "edit")
        return success()

    @app.route("/api/workgroup/remove-contributor", methods=["DELETE"])
    def remove_contributor(request: Request):
        caller = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        contributor = body.get("contributor", "")
        namespace = body.get("namespace", "")
        if not (manager.is_owner(caller, namespace)
                or manager.is_cluster_admin(caller)):
            raise HttpError(403, "only the namespace owner may remove contributors")
        manager.delete_binding(contributor, namespace, "edit")
        return success()

    return app


def _settings(client) -> dict:
    try:
        cm = client.get(CONFIGMAP, SETTINGS_CONFIGMAP, SETTINGS_NAMESPACE)
    except errors.ApiError:
        return {}
    out = {}
    for key, raw in (cm.get("data") or {}).items():
        try:
            out[key] = json.loads(raw)
        except (TypeError, ValueError):
            out[key] = raw
    return out


def _default_namespace(user: str) -> str:
    return "kubeflow-" + _sanitize(user.split("@")[0])
