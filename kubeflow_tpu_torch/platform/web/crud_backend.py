"""Shared CRUD-backend library: authn, authz, CSRF, probes, k8s helpers.

The port's copy of ``kubeflow_tpu/platform/web/crud_backend.py`` (the
reference's ``kubeflow.kubeflow.crud_backend`` package): every web app
(jupyter, volumes, tensorboards) and KFAM compose these pieces over the
framework of ``framework.py``.

Security model (as the reference's): identity is a **trusted HTTP
header** set by the Istio gateway, authorization is a
SubjectAccessReview per k8s-touching call (``CrudBackend.ensure``, one
``can_i`` a call), and CSRF is a double-submit cookie.
"""
from __future__ import annotations

import json
import secrets as pysecrets
import threading
from typing import Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s.types import GVK
from kubeflow_tpu_torch.platform.web.framework import (
    App,
    HttpError,
    Request,
    Response,
    json_response,
)

# Request-scoped "this response was served from a possibly-stale cache"
# flag (thread-local: one request per server thread).  Set by the
# cache_or_client_* degraded fallback, cleared per request and folded
# into the JSON envelope (``degraded: true``) by the middleware below.
_degraded = threading.local()


def _mark_degraded(_exc) -> None:
    _degraded.flag = True


def _clear_degraded() -> None:
    _degraded.flag = False


def _is_degraded() -> bool:
    return getattr(_degraded, "flag", False)


class AuthContext:
    def __init__(self, *, userid_header: Optional[str] = None,
                 userid_prefix: Optional[str] = None,
                 disable_auth: Optional[bool] = None):
        self.userid_header = userid_header or config.env("USERID_HEADER", "kubeflow-userid")
        self.userid_prefix = (
            userid_prefix if userid_prefix is not None
            else config.env("USERID_PREFIX", "")
        )
        self.disable_auth = (
            disable_auth if disable_auth is not None
            else config.env_bool("APP_DISABLE_AUTH", False)
        )

    def user_of(self, request: Request) -> Optional[str]:
        if self.disable_auth:
            return config.env("DEV_USER", "dev-user@kubeflow.org")
        raw = request.headers.get(self.userid_header)
        if raw is None:
            return None
        if self.userid_prefix and raw.startswith(self.userid_prefix):
            raw = raw[len(self.userid_prefix):]
        return raw


def no_authentication(fn):
    """Route decorator: skip the authn gate (liveness probes etc.)."""
    fn._no_auth = True
    return fn


class CrudBackend:
    """Bundles client + auth for the per-resource API helpers.

    ``caches`` is an optional {GVK: started Informer}: kinds present there
    are READ from the shared informer cache (zero-copy frozen views)
    instead of a per-request LIST/GET; every read is still
    SubjectAccessReview-gated, and an unsynced cache falls back to the
    live client so a cold start never serves "nothing" as authoritative.
    Writes always go to the client."""

    def __init__(self, client, auth: Optional[AuthContext] = None, *,
                 caches: Optional[dict] = None):
        self.client = client
        self.auth = auth or AuthContext()
        self.caches = caches or {}

    # -- authz gate ----------------------------------------------------------

    def ensure(self, user: str, verb: str, gvk: GVK, namespace: Optional[str] = None,
               subresource: str = ""):
        if self.auth.disable_auth:
            return
        if not self.client.can_i(user, verb, gvk, namespace, subresource=subresource):
            raise HttpError(
                403,
                f"user {user!r} cannot {verb} {gvk.plural}"
                + (f"/{subresource}" if subresource else "")
                + (f" in namespace {namespace}" if namespace else ""),
            )

    # -- generic verbs (each authz-gated like the reference api/ wrappers) ---

    def list_resources(self, user, gvk, namespace=None, label_selector=None):
        from kubeflow_tpu_torch.platform.runtime.informer import (
            cache_or_client_list,
        )

        self.ensure(user, "list", gvk, namespace)
        # on_degraded: a transient live-LIST failure with a cache wired
        # serves the cache and stamps ``degraded: true`` on the response
        # instead of a 500.
        return cache_or_client_list(self.caches.get(gvk), self.client, gvk,
                                    namespace, label_selector=label_selector,
                                    on_degraded=_mark_degraded)

    def get_resource(self, user, gvk, name, namespace=None):
        from kubeflow_tpu_torch.platform.runtime.informer import (
            cache_or_client_get,
        )

        self.ensure(user, "get", gvk, namespace)
        # read_through: a UI GET right after its own POST must not 404
        # out of a cache the watch delta hasn't reached yet.
        obj = cache_or_client_get(self.caches.get(gvk), self.client, gvk,
                                  name, namespace, read_through=True,
                                  on_degraded=_mark_degraded)
        if obj is None:
            from kubeflow_tpu_torch.platform.k8s import errors

            raise errors.NotFound(
                f'{gvk.plural} "{name}" not found'
                + (f' in namespace "{namespace}"' if namespace else ""))
        return obj

    def create_resource(self, user, obj, *, dry_run=False):
        from kubeflow_tpu_torch.platform.k8s.types import gvk_of, namespace_of

        self.ensure(user, "create", gvk_of(obj), namespace_of(obj))
        return self.client.create(obj, dry_run=dry_run)

    def patch_resource(self, user, gvk, name, patch, namespace=None):
        self.ensure(user, "patch", gvk, namespace)
        return self.client.patch(gvk, name, patch, namespace)

    def delete_resource(self, user, gvk, name, namespace=None):
        self.ensure(user, "delete", gvk, namespace)
        return self.client.delete(gvk, name, namespace)

    def pod_logs(self, user, name, namespace, *, container=None) -> str:
        """Authz on the pods/log subresource, as the reference's."""
        from kubeflow_tpu_torch.platform.k8s.types import POD

        self.ensure(user, "get", POD, namespace, subresource="log")
        return self.client.pod_logs(name, namespace, container=container)


CSRF_COOKIE = "XSRF-TOKEN"
CSRF_HEADER = "X-XSRF-TOKEN"
SAFE_METHODS = {"GET", "HEAD", "OPTIONS"}


def _kind_of_rule(rule: Optional[str]) -> Optional[str]:
    """Resource kind a route serves, from its rule pattern: the first
    static segment after ``/api``, where ``namespaces/<ns>`` is a scope
    prefix but a bare ``/api/namespaces`` addresses the Namespace kind
    itself — "/api/namespaces/<ns>/notebooks/<name>/pod" -> "notebooks",
    "/api/namespaces" -> "namespaces", "/api/storageclasses" ->
    "storageclasses".  None for non-/api routes (probes, /metrics, kfam's
    /kfam/v1 tree which counts itself)."""
    if not rule or not rule.startswith("/api/"):
        return None
    parts = [p for p in rule.split("/") if p]
    i = 1  # parts[0] == "api"
    if (i + 1 < len(parts) and parts[i] == "namespaces"
            and parts[i + 1].startswith("<")):
        i += 2  # skip the namespaces/<ns> scope
    while i < len(parts) and parts[i].startswith("<"):
        i += 1
    return parts[i] if i < len(parts) else None


def install_standard_middleware(app: App, backend: CrudBackend, *,
                                secure_cookies: Optional[bool] = None) -> None:
    """authn gate + CSRF double-submit + probes, shared by every web app."""
    secure = (
        secure_cookies if secure_cookies is not None
        else config.env("APP_SECURE_COOKIES", "true").lower() == "true"
    )

    @app.before_request
    def reset_degraded(request: Request) -> Optional[Response]:
        # Thread-local, so a previous request's degraded read on this
        # server thread must not taint the current response.
        _clear_degraded()
        return None

    @app.before_request
    def authn_gate(request: Request) -> Optional[Response]:
        view = app.view_of(request)
        if view is not None and getattr(view, "_no_auth", False):
            return None
        user = backend.auth.user_of(request)
        if user is None:
            return json_response(
                {"success": False, "status": 401,
                 "log": f"missing identity header {backend.auth.userid_header}"},
                401,
            )
        request.environ["kubeflow.user"] = user
        return None

    @app.before_request
    def csrf_gate(request: Request) -> Optional[Response]:
        if not secure or request.method in SAFE_METHODS:
            return None
        cookie = request.cookies.get(CSRF_COOKIE)
        header = request.headers.get(CSRF_HEADER)
        if not cookie or cookie != header:
            return json_response(
                {"success": False, "status": 403, "log": "CSRF check failed"}, 403
            )
        return None

    @app.after_request
    def count_request(request: Request, response: Response) -> Response:
        # Per-kind request counters on the shared framework, so every web
        # app reports request_kf as KFAM does, without per-app wiring.
        # 5xx is a service failure; 4xx is the client's problem.
        kind = _kind_of_rule(request.environ.get("kubeflow.route_rule"))
        if kind is not None:
            from kubeflow_tpu_torch.platform.runtime import metrics

            if response.status_code >= 500:
                metrics.request_kf_failure.labels(
                    component=app.name, kind=kind,
                    severity=metrics.SEVERITY_MAJOR,
                ).inc()
            else:
                metrics.request_kf.labels(
                    component=app.name, kind=kind).inc()
        return response

    @app.after_request
    def stamp_degraded(request: Request, response: Response) -> Response:
        # A successful JSON response built from a degraded (cache-served)
        # read carries ``degraded: true`` so UIs can badge the staleness;
        # error responses are left alone.  Runs only when a read actually
        # degraded, so the happy path never re-parses its own JSON.
        if not _is_degraded():
            return response
        _clear_degraded()
        if (response.status_code < 400
                and (response.content_type or "").startswith(
                    "application/json")):
            try:
                body = json.loads(response.get_data(as_text=True))
            except ValueError:
                return response
            if isinstance(body, dict):
                body["degraded"] = True
                response.set_data(json.dumps(body))
                from kubeflow_tpu_torch.platform.runtime import metrics

                metrics.degraded_responses_total.labels(
                    component=app.name).inc()
        return response

    @app.after_request
    def set_csrf_cookie(request: Request, response: Response) -> Response:
        if secure and CSRF_COOKIE not in request.cookies:
            response.set_cookie(
                CSRF_COOKIE, pysecrets.token_urlsafe(32),
                secure=True, samesite="Strict", path="/",
            )
        return response

    @app.route("/healthz")
    @no_authentication
    def healthz(request: Request):
        body = {"status": "ok"}
        # The REST client's circuit-breaker state rides along where one
        # exists: "the app is fine, the API server path is not".  An open
        # circuit stays 200: restarting a web replica doesn't fix an
        # unreachable API server.
        if hasattr(backend.client, "health"):
            body["rest_client"] = backend.client.health()
        return json_response(body)

    @app.route("/metrics")
    @no_authentication
    def metrics_route(request: Request):
        from kubeflow_tpu_torch.platform.runtime import metrics as m

        return Response(m.render(), content_type="text/plain; version=0.0.4")


def current_user(request: Request) -> str:
    return request.environ.get("kubeflow.user", "")
