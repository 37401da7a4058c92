"""Jupyter web app (JWA) backend: the spawner + notebook table REST API.

The port's copy of ``kubeflow_tpu/platform/apps/jupyter/app.py``.
Routes mirror the reference (reference jupyter/backend/apps/common/
routes/get.py:15-123, default/routes/post.py:11-72, common/routes/
patch.py:17-80, delete.py:8-17) with the accelerator endpoint as ``GET
/api/namespaces/<ns>/gpus``: the offered (accelerator, GPU counts)
options intersected with what the cluster's nodes expose, and the
namespace's GPU budget.  A notebook's quota footprint counts
``requests.nvidia.com/gpu`` from its ``spec.gpu``.
"""
from __future__ import annotations

import datetime
from typing import Optional

from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.apps.jupyter import form as form_mod
from kubeflow_tpu_torch.platform.apps.jupyter.status import process_status
from kubeflow_tpu_torch.platform.gpu import gpus_on_nodes, slice_spec
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import quota as quota_mod
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    NODE,
    NOTEBOOK,
    POD,
    PODDEFAULT,
    PVC,
    RESOURCEQUOTA,
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


def create_app(client, *, auth=None, spawner_config_path: Optional[str] = None,
               secure_cookies: Optional[bool] = None,
               caches: Optional[dict] = None) -> App:
    """``caches`` ({GVK: started Informer}, optional) turns the table/
    picker/pre-flight reads into zero-copy frozen-view cache reads (the
    reference JWA reads through client-go informers the same way); absent
    or unsynced caches fall back to live LISTs.  All the read sites below
    are read-only, so both shapes behave identically."""
    app = App("jupyter-web-app")
    backend = CrudBackend(client, auth, caches=caches)
    install_standard_middleware(app, backend, secure_cookies=secure_cookies)
    from kubeflow_tpu_torch.platform.web.static_serving import install_frontend

    install_frontend(app, "jupyter")
    cfg_path = spawner_config_path

    def _cached_list(gvk, ns):
        """DISPLAY reads with the app's OWN client (not the user's SAR —
        see get_gpus), through the informer cache when one is wired and
        synced.  Display only: quota ADMISSION (_quota_preflight and the
        restart gate in patch_notebook) always reads LIVE — an admission
        decision needs read-your-writes consistency the watch-propagation
        window can't guarantee, and the pre-flight exists precisely to
        stop a spawn that a stale read would wave through."""
        from kubeflow_tpu_torch.platform.runtime.informer import cache_or_client_list

        return cache_or_client_list((caches or {}).get(gvk), client, gvk, ns)

    # -- config & environment -------------------------------------------------

    @app.route("/api/config")
    def get_config(request: Request):
        return success({"config": form_mod.load_spawner_config(cfg_path)})

    @app.route("/api/namespaces/<ns>/gpus")
    def get_gpus(request: Request, ns: str):
        """Offered GPU options ∩ node capacity — the analogue of the
        reference's GET /api/gpus vendor∩capacity scan (get.py:102-123).
        A count is offered where a node of the accelerator holds one of
        its pods (``slice_spec(...).gpus_per_pod`` GPUs: the count itself
        within a host, a whole host beyond one)."""
        user = current_user(request)
        nodes = backend.list_resources(user, NODE)
        present = gpus_on_nodes(nodes)
        offered = form_mod.load_spawner_config(cfg_path).get("gpus", {}).get(
            "options", []
        )
        out = []
        for option in offered:
            acc = option.get("accelerator")
            if acc not in present:
                continue
            # Never surface a count the admin didn't offer — the spawn
            # endpoint would reject it.
            largest = max(present[acc])
            counts = []
            for n in option.get("gpus", []):
                try:
                    if slice_spec(acc, n).gpus_per_pod <= largest:
                        counts.append(n)
                except ValueError:
                    continue
            if counts:
                out.append({"accelerator": acc, "gpus": counts})
        # Per-namespace GPU budget (hard − used) so the picker can disable
        # over-quota counts and show "N of H GPUs remaining".  Read with the
        # app's own client, not the user's SAR: this reflects what quota
        # admission will do to the spawn regardless of whether the user may
        # list ResourceQuota objects.  The shared helper applies the same
        # effective_used accounting as the pre-flight so the picker never
        # enables a count the submit would 403.
        return success({
            "gpus": out,
            "quota": nbapi.namespace_gpu_budget(client, ns,
                                                lister=_cached_list),
        })

    # -- notebooks ------------------------------------------------------------

    @app.route("/api/namespaces/<ns>/notebooks")
    def list_notebooks(request: Request, ns: str):
        user = current_user(request)
        notebooks = backend.list_resources(user, NOTEBOOK, ns)
        events_by_nb = _warning_events(user, ns)
        out = [
            _notebook_row(nb, events_by_nb.get(name_of(nb), []))
            for nb in notebooks
        ]
        return success({"notebooks": out})

    @app.route("/api/namespaces/<ns>/notebooks/<name>")
    def get_notebook(request: Request, ns: str, name: str):
        user = current_user(request)
        nb = backend.get_resource(user, NOTEBOOK, name, ns)
        return success({"notebook": nb})

    @app.route("/api/namespaces/<ns>/notebooks/<name>/pod")
    def get_notebook_pod(request: Request, ns: str, name: str):
        user = current_user(request)
        pods = backend.list_resources(
            user, POD, ns, label_selector={nbapi.LABEL_NOTEBOOK_NAME: name}
        )
        if not pods:
            raise HttpError(404, f"no pods for notebook {name}")
        # "pod" is worker 0 (back-compat); "pods" lists every worker of a
        # multi-host slice for the detail page's log selector, in ordinal
        # order (lexicographic would put nb-10 before nb-2).
        def ordinal(pod):
            prefix, _, tail = name_of(pod).rpartition("-")
            return (prefix, int(tail)) if tail.isdigit() else (name_of(pod), -1)

        pods = sorted(pods, key=ordinal)
        return success({"pod": pods[0], "pods": [name_of(p) for p in pods]})

    @app.route("/api/namespaces/<ns>/notebooks/<name>/pod/<pod>/logs")
    def get_pod_logs(request: Request, ns: str, name: str, pod: str):
        """Container logs for one worker pod (reference get.py:99-105); the
        container is named after the notebook, as generate_statefulset
        defaults it."""
        user = current_user(request)
        logs = backend.pod_logs(user, pod, ns, container=name)
        return success({"logs": logs.split("\n")})

    @app.route("/api/namespaces/<ns>/notebooks/<name>/events")
    def get_notebook_events(request: Request, ns: str, name: str):
        user = current_user(request)
        def involves(ev) -> bool:
            obj = deep_get(ev, "involvedObject", "name", default="")
            # Exact object or its children (nb-0, nb.17c9...), NOT prefix
            # siblings (nb10 must not show in nb1's drawer).
            return obj == name or obj.startswith(name + "-") or obj.startswith(name + ".")

        events = [ev for ev in backend.list_resources(user, EVENT, ns) if involves(ev)]
        return success({"events": events})

    @app.route("/api/namespaces/<ns>/notebooks", methods=["POST"])
    def post_notebook(request: Request, ns: str):
        user = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        body["namespace"] = ns
        defaults = form_mod.load_spawner_config(cfg_path)
        nb, pvcs = form_mod.build_notebook(body, defaults)
        nbapi.validate(nb)
        # Quota pre-flight: the real denial happens at pod admission when
        # the StatefulSet scales up, which would strand the user with a
        # notebook that never starts.  Evaluate the notebook's aggregate
        # worker footprint against the namespace quotas up front and turn
        # it into a 403 the form can show.
        _quota_preflight(ns, nb)
        # Dry-run first (reference post.py:48-54): catch quota/validation
        # rejections before any PVC is created.
        backend.create_resource(user, nb, dry_run=True)
        for pvc in pvcs:
            try:
                backend.create_resource(user, pvc)
            except errors.Conflict:
                pass  # existing claim reused
        created = backend.create_resource(user, nb)
        return success({"notebook": created}, status=200)

    @app.route("/api/namespaces/<ns>/notebooks/<name>", methods=["PATCH"])
    def patch_notebook(request: Request, ns: str, name: str):
        user = current_user(request)
        body = request.get_json(force=True, silent=True) or {}
        stopped = body.get("stopped")
        if stopped is None:
            raise HttpError(400, "body must include 'stopped': true|false")
        if stopped:
            patch = {"metadata": {"annotations": {
                nbapi.STOP_ANNOTATION: datetime.datetime.now(
                    datetime.timezone.utc
                ).strftime("%Y-%m-%dT%H:%M:%SZ"),
            }}}
        else:
            # Restart re-claims the notebook's GPUs: run the same quota
            # pre-flight as a fresh spawn (the stopped CR is excluded from
            # the declared tally, so it only checks against OTHERS' usage)
            # — otherwise the StatefulSet scales up into a pod-admission
            # 403 and strands with no user-facing error.  LIVE read (authz
            # still gated): a stop-then-start inside the cache-propagation
            # window must not see the stale not-stopped object and skip
            # the pre-flight.
            backend.ensure(user, "get", NOTEBOOK, ns)
            current = client.get(NOTEBOOK, name, ns)
            if nbapi.is_stopped(current):
                _quota_preflight(ns, current)
            patch = {"metadata": {"annotations": {nbapi.STOP_ANNOTATION: None}}}
        out = backend.patch_resource(user, NOTEBOOK, name, patch, ns)
        return success({"notebook": out})

    @app.route("/api/namespaces/<ns>/notebooks/<name>", methods=["DELETE"])
    def delete_notebook(request: Request, ns: str, name: str):
        user = current_user(request)
        backend.delete_resource(user, NOTEBOOK, name, ns)
        return success()

    # -- supporting resources -------------------------------------------------

    @app.route("/api/namespaces/<ns>/pvcs")
    def list_pvcs(request: Request, ns: str):
        user = current_user(request)
        return success({"pvcs": backend.list_resources(user, PVC, ns)})

    @app.route("/api/namespaces/<ns>/poddefaults")
    def list_poddefaults(request: Request, ns: str):
        user = current_user(request)
        pds = backend.list_resources(user, PODDEFAULT, ns)
        out = [{
            "label": _pd_label(pd),
            "desc": deep_get(pd, "spec", "desc", default=name_of(pd)),
            "name": name_of(pd),
        } for pd in pds]
        return success({"poddefaults": out})

    # -- helpers --------------------------------------------------------------

    def _notebook_usage(nb) -> dict:
        """A notebook's declared aggregate footprint: its GPUs across
        every host of every slice, cpu/memory per worker × worker count —
        the same math quota admission will apply to its pods."""
        template_pod = {"spec": deep_get(nb, "spec", "template", "spec",
                                         default={}) or {}}
        try:
            spec = nbapi.gpu_slice(nb)
        except ValueError:
            spec = None  # validate() rejects it; don't double-report
        try:
            return quota_mod.notebook_gpu_usage(template_pod, spec)
        except ValueError as e:
            # User-typed quantity ("cpu": "abc") — a form error, not a 500.
            raise HttpError(400, f"invalid resource quantity: {e}")

    def _stored_usage(nb) -> dict:
        """_notebook_usage for an already-stored CR: junk quantities in
        someone else's object must not fail THIS user's request."""
        try:
            return _notebook_usage(nb)
        except HttpError:
            return {}

    def _running_notebooks(ns: str) -> list:
        """One NOTEBOOK list shared by the declared-usage and pod-usage
        accounting — the spawn/pre-flight hot path must not pay two
        O(namespace) LISTs (and two lists could disagree mid-flight).
        LIVE list, not the cache: a just-accepted notebook must count
        against the next spawn immediately (read-your-writes), or two
        rapid spawns both slip under the quota."""
        return [nb for nb in client.list(NOTEBOOK, ns)
                if not nbapi.is_stopped(nb)]

    def _quota_preflight(ns: str, nb) -> None:
        """403 if the notebook's worker pods would exceed a namespace quota.

        Counts the declared footprint of every running notebook CR (a
        just-accepted notebook claims its GPUs here before its pods
        exist, so back-to-back spawns can't both slip under the quota and
        strand the second one at pod admission) PLUS live usage by
        non-notebook pods — see quota.effective_used for why neither a
        plain status.used nor max(status.used, declared) is enough.
        """
        # Admission path: every read LIVE (see _cached_list docstring).
        quotas = client.list(RESOURCEQUOTA, ns)
        if not quotas:
            return
        usage = _notebook_usage(nb)
        running = _running_notebooks(ns)
        declared: dict = {}
        for other in running:
            declared = quota_mod.add_usage(declared, _stored_usage(other))
        # Shared with the picker and dashboard card (ONE implementation so
        # the surfaces cannot drift apart); it also skips pods carrying
        # malformed resource quantities, which must not 500 the spawner.
        nb_pod_used = nbapi.running_notebook_pod_usage(client, ns, running)
        override = {}
        for q in quotas:
            hard = deep_get(q, "spec", "hard", default={}) or {}
            used_map = deep_get(q, "status", "used", default={}) or {}
            effective = {}
            for key in hard:
                ukey = quota_mod.usage_key(key)
                try:
                    stored = quota_mod.parse_quantity(
                        used_map.get(key, 0.0) or 0.0)
                except ValueError:
                    stored = 0.0
                effective[ukey] = quota_mod.effective_used(
                    stored, declared.get(ukey, 0.0),
                    nb_pod_used.get(ukey, 0.0))
            override[name_of(q)] = effective
        violation = quota_mod.find_violation(quotas, usage,
                                             used_override=override)
        if violation is None:
            return
        if quota_mod.usage_key(violation.hard_key) == nbapi.GPU_REQUESTS:
            msg = (f"GPU quota exceeded (requested "
                   f"{int(violation.requested)}, remaining "
                   f"{int(violation.remaining)} of "
                   f"{int(violation.hard)} GPUs in {ns})")
        else:
            msg = f"namespace quota exceeded: {violation.message()}"
        raise HttpError(403, msg)

    def _warning_events(user, ns):
        out: dict = {}
        try:
            events = backend.list_resources(user, EVENT, ns)
        except HttpError:
            return out
        for ev in events:
            name = deep_get(ev, "involvedObject", "name", default="")
            base = name.split(".")[0].rsplit("-", 1)[0] if "-" in name else name
            out.setdefault(base, []).append(ev)
            out.setdefault(name, []).append(ev)
        return out

    return app


def _pd_label(pd) -> str:
    match = deep_get(pd, "spec", "selector", "matchLabels", default={}) or {}
    return next(iter(match), name_of(pd))


def _notebook_row(nb, events) -> dict:
    gpu = deep_get(nb, "spec", "gpu", default=None)
    container = deep_get(
        nb, "spec", "template", "spec", "containers", default=[{}]
    )[0]
    row = {
        "name": name_of(nb),
        "namespace": deep_get(nb, "metadata", "namespace"),
        "image": container.get("image", ""),
        "shortImage": (container.get("image", "").split("/")[-1]),
        "cpu": deep_get(container, "resources", "requests", "cpu", default=""),
        "memory": deep_get(container, "resources", "requests", "memory", default=""),
        "gpu": gpu,
        "age": deep_get(nb, "metadata", "creationTimestamp", default=""),
        "labels": deep_get(nb, "metadata", "labels", default={}),
        "status": process_status(nb, events),
    }
    return row
