"""Profile controller: one Profile CR = one user workspace.

The port's copy of ``kubeflow_tpu/platform/controllers/profile.py``
(reference profile_controller.go:105-331): create/adopt the namespace
(rejecting takeover of foreign namespaces), stamp RBAC (editor/viewer
service accounts + role bindings, owner admin binding), emit the Istio
AuthorizationPolicy that makes the trusted user-header model safe, and
materialize the per-namespace ResourceQuota ``kf-resource-quota`` from
``spec.resourceQuotaSpec`` — which on this platform is where **GPU
quotas** live (``nvidia.com/gpu`` in ``spec.resourceQuotaSpec.hard``,
which the spawner's pre-flight and the pods' quota admission read).

Cloud-identity plugins (GCP Workload Identity / AWS IRSA,
reference plugin_workload_identity.go / plugin_iam.go) keep the same CR
contract; the cloud IAM round-trip is behind an injectable interface so the
in-cluster annotation side works everywhere and clouds plug in via config.
A ``profile-finalizer`` drives revocation on delete.
"""
from __future__ import annotations

import copy
import json
from typing import Callable, Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    AUTHORIZATIONPOLICY,
    NAMESPACE,
    PROFILE,
    RESOURCEQUOTA,
    ROLEBINDING,
    SERVICEACCOUNT,
    Resource,
    deep_get,
    meta,
    name_of,
    set_owner,
)
from kubeflow_tpu_torch.platform.runtime import EventRecorder, Reconciler, Request, Result
from kubeflow_tpu_torch.platform.runtime import apply
from kubeflow_tpu_torch.platform.runtime import metrics

OWNER_ANNOTATION = "owner"
FINALIZER = "profile-finalizer"
QUOTA_NAME = "kf-resource-quota"
AUTH_POLICY_NAME = "ns-owner-access-istio"

EDITOR_SA = "default-editor"
VIEWER_SA = "default-viewer"
ADMIN_BINDING = "namespaceAdmin"
CLUSTER_ROLE_ADMIN = "kubeflow-admin"
CLUSTER_ROLE_EDIT = "kubeflow-edit"
CLUSTER_ROLE_VIEW = "kubeflow-view"


# YAML 1.1's booleans, which the reference's loader turns into True/False.
_YAML_BOOLS = {"true": "True", "yes": "True", "on": "True",
               "false": "False", "no": "False", "off": "False"}


def read_labels_file(text: str) -> Dict[str, str]:
    """The namespace-labels file: a JSON object, or ``key: value`` lines
    (blank lines and ``#`` comments skipped, a quoted value unquoted, a
    YAML boolean read as the reference's loader reads it) — the flat map
    the reference reads with ``yaml.safe_load``, with no yaml on the
    card's machine.  Raises ValueError on anything else."""
    stripped = text.strip()
    if not stripped:
        return {}
    if stripped.startswith("{"):
        data = json.loads(stripped)
        if not isinstance(data, dict):
            raise ValueError("labels file: not an object")
        return {str(k): str(v) for k, v in data.items()}
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split(" #", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0].isspace():
            raise ValueError(f"labels file: nested value {line!r}")
        key, sep, value = line.partition(":")
        if not sep or not key.strip():
            raise ValueError(f"labels file: not key: value {line!r}")
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
            value = value[1:-1]
        else:
            value = _YAML_BOOLS.get(value.lower(), value)
        out[key.strip().strip("'\"")] = value
    return out


class ProfilePlugin:
    """Apply/Revoke contract (reference profile_controller.go:77-83)."""

    kind = ""

    def apply(self, client, profile: Resource, plugin_spec: dict) -> None: ...

    def revoke(self, client, profile: Resource, plugin_spec: dict) -> None: ...


class WorkloadIdentityPlugin(ProfilePlugin):
    """GCP: annotate the editor KSA; IAM binding via injected callback.

    The IAM member must carry the cluster's workload-identity pool
    (``PROJECT_ID.svc.id.goog``), resolved from the constructor or the
    WORKLOAD_IDENTITY_POOL / GCP_PROJECT env (reference
    plugin_workload_identity.go builds the same member string).
    """

    kind = "WorkloadIdentity"

    def __init__(self, bind_iam: Optional[Callable[[str, str, bool], None]] = None,
                 *, identity_pool: Optional[str] = None):
        self.bind_iam = bind_iam  # (gcp_sa, member, add) -> None
        pool = identity_pool or config.env("WORKLOAD_IDENTITY_POOL")
        if not pool and config.env("GCP_PROJECT"):
            pool = f"{config.env('GCP_PROJECT')}.svc.id.goog"
        self.identity_pool = pool

    def _member(self, profile: Resource) -> str:
        return (
            f"serviceAccount:{self.identity_pool}"
            f"[{name_of(profile)}/{EDITOR_SA}]"
        )

    def _annotate(self, client, profile, gcp_sa: Optional[str]) -> None:
        ns = name_of(profile)
        sa = client.get(SERVICEACCOUNT, EDITOR_SA, ns)
        annotations = meta(sa).setdefault("annotations", {})
        if gcp_sa:
            annotations["iam.gke.io/gcp-service-account"] = gcp_sa
        else:
            annotations.pop("iam.gke.io/gcp-service-account", None)
        client.update(sa)

    def apply(self, client, profile, plugin_spec) -> None:
        gcp_sa = plugin_spec.get("gcpServiceAccount", "")
        self._annotate(client, profile, gcp_sa)
        if self.bind_iam and gcp_sa and self.identity_pool:
            self.bind_iam(gcp_sa, self._member(profile), True)

    def revoke(self, client, profile, plugin_spec) -> None:
        gcp_sa = plugin_spec.get("gcpServiceAccount", "")
        if self.bind_iam and gcp_sa and self.identity_pool:
            self.bind_iam(gcp_sa, self._member(profile), False)


class IrsaPlugin(ProfilePlugin):
    """AWS IRSA: role-arn annotation; trust-policy edit via injected callback."""

    kind = "AwsIamForServiceAccount"

    def __init__(self, edit_trust: Optional[Callable[[str, str, bool], None]] = None):
        self.edit_trust = edit_trust

    def apply(self, client, profile, plugin_spec) -> None:
        arn = plugin_spec.get("awsIamRole", "")
        ns = name_of(profile)
        sa = client.get(SERVICEACCOUNT, EDITOR_SA, ns)
        meta(sa).setdefault("annotations", {})["eks.amazonaws.com/role-arn"] = arn
        client.update(sa)
        if self.edit_trust and arn:
            self.edit_trust(arn, f"system:serviceaccount:{ns}:{EDITOR_SA}", True)

    def revoke(self, client, profile, plugin_spec) -> None:
        arn = plugin_spec.get("awsIamRole", "")
        if self.edit_trust and arn:
            ns = name_of(profile)
            self.edit_trust(arn, f"system:serviceaccount:{ns}:{EDITOR_SA}", False)


class ProfileReconciler(Reconciler):
    def __init__(
        self,
        client,
        *,
        userid_header: Optional[str] = None,
        userid_prefix: Optional[str] = None,
        default_namespace_labels: Optional[Dict[str, str]] = None,
        default_namespace_labels_path: Optional[str] = None,
        plugins: Optional[List[ProfilePlugin]] = None,
        notebook_controller_sa: str = "system:serviceaccount:kubeflow:notebook-controller-service-account",
    ):
        self.client = client
        self.recorder = EventRecorder(client, "profile-controller")
        self.userid_header = userid_header or config.env("USERID_HEADER", "kubeflow-userid")
        self.userid_prefix = (
            userid_prefix if userid_prefix is not None else config.env("USERID_PREFIX", "")
        )
        self.labels_path = default_namespace_labels_path
        self.default_labels = default_namespace_labels or {
            "istio-injection": "enabled",
            "app.kubernetes.io/part-of": "kubeflow-profile",
        }
        self.plugins = {p.kind: p for p in (plugins or [WorkloadIdentityPlugin(), IrsaPlugin()])}
        self.notebook_controller_sa = notebook_controller_sa

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            profile = self.client.get(PROFILE, req.name)
        except errors.NotFound:
            return None

        if meta(profile).get("deletionTimestamp"):
            self._revoke_plugins(profile)
            finalizers = [f for f in meta(profile).get("finalizers", []) if f != FINALIZER]
            profile = copy.deepcopy(profile)
            meta(profile)["finalizers"] = finalizers
            self.client.update(profile)
            return None

        if FINALIZER not in meta(profile).get("finalizers", []):
            profile = copy.deepcopy(profile)
            meta(profile).setdefault("finalizers", []).append(FINALIZER)
            profile = self.client.update(profile)

        if not self._counted("namespace", self._reconcile_namespace, profile):
            return None  # ownership conflict surfaced on status
        self._counted("serviceaccount", self._reconcile_service_accounts, profile)
        self._counted("rolebinding", self._reconcile_role_bindings, profile)
        self._counted("authorizationpolicy", self._reconcile_authorization_policy, profile)
        self._counted("resourcequota", self._reconcile_resource_quota, profile)
        self._counted("plugin", self._apply_plugins, profile)
        self._set_ready(profile)
        return None

    def _counted(self, kind: str, fn, *args):
        """Per-kind request/failure counters around each reconcile step
        (reference monitoring.go:28-44 IncRequestCounter pattern)."""
        try:
            result = fn(*args)
        except Exception:
            metrics.request_kf_failure.labels(
                component="profile", kind=kind, severity=metrics.SEVERITY_MAJOR
            ).inc()
            raise
        metrics.request_kf.labels(component="profile", kind=kind).inc()
        return result

    # -- namespace -----------------------------------------------------------

    def _current_default_labels(self) -> Dict[str, str]:
        """Default namespace labels, re-read from the mounted file on every
        reconcile when a path is configured — paired with the mtime watcher
        in make_controller this gives the reference's hot-reload semantics
        (reference profile_controller.go:368-399, :762-777).  The file is a
        flat map (``read_labels_file``)."""
        if self.labels_path:
            try:
                with open(self.labels_path) as f:
                    data = read_labels_file(f.read())
            except (OSError, ValueError):
                # A bad config edit must not wedge every Profile reconcile;
                # fall back to the static defaults until the file is fixed.
                return dict(self.default_labels)
            if isinstance(data, dict):
                return data
        return dict(self.default_labels)

    def _reconcile_namespace(self, profile: Resource) -> bool:
        name = name_of(profile)
        owner = deep_get(profile, "spec", "owner", "name", default="")
        default_labels = self._current_default_labels()
        try:
            ns = self.client.get(NAMESPACE, name)
        except errors.NotFound:
            ns = {
                "apiVersion": "v1",
                "kind": "Namespace",
                "metadata": {
                    "name": name,
                    "annotations": {OWNER_ANNOTATION: owner},
                    "labels": dict(default_labels),
                },
            }
            set_owner(ns, profile)
            apply.create(self.client, ns)
            return True
        existing_owner = deep_get(ns, "metadata", "annotations", OWNER_ANNOTATION)
        if existing_owner is None:
            # Pre-existing namespace not created for a profile: refuse to
            # take it over (reference :127-198 ownership check).
            self._set_failed(
                profile,
                f"namespace {name} exists and is not owned by any profile",
            )
            return False
        if existing_owner != owner:
            self._set_failed(
                profile,
                f"namespace {name} is owned by {existing_owner!r}, not {owner!r}",
            )
            return False
        changed = False
        labels = meta(ns).setdefault("labels", {})
        for k, v in default_labels.items():
            if labels.get(k) != v:
                labels[k] = v
                changed = True
        if changed:
            self.client.update(ns)
        return True

    # -- rbac ----------------------------------------------------------------

    def _reconcile_service_accounts(self, profile: Resource) -> None:
        ns = name_of(profile)
        for sa_name in (EDITOR_SA, VIEWER_SA):
            sa = {
                "apiVersion": "v1",
                "kind": "ServiceAccount",
                "metadata": {"name": sa_name, "namespace": ns},
            }
            set_owner(sa, profile)
            try:
                apply.create(self.client, sa)
            except errors.Conflict:
                pass

    def _reconcile_role_bindings(self, profile: Resource) -> None:
        ns = name_of(profile)
        owner = deep_get(profile, "spec", "owner", default={})
        bindings = [
            (EDITOR_SA, CLUSTER_ROLE_EDIT,
             {"kind": "ServiceAccount", "name": EDITOR_SA, "namespace": ns}),
            (VIEWER_SA, CLUSTER_ROLE_VIEW,
             {"kind": "ServiceAccount", "name": VIEWER_SA, "namespace": ns}),
            (ADMIN_BINDING, CLUSTER_ROLE_ADMIN, {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": owner.get("kind", "User"),
                "name": owner.get("name", ""),
            }),
        ]
        for binding_name, role, subject in bindings:
            # The role/user annotations are KFAM's marker for USER bindings
            # (what the contributors view lists); the ServiceAccount
            # bindings must not carry them or default-editor/viewer show up
            # as namespace contributors (caught by the DOM frontend tests).
            annotations = {}
            if subject.get("kind") != "ServiceAccount":
                annotations = {"role": role.removeprefix("kubeflow-"),
                               "user": subject.get("name", "")}
            rb = {
                "apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "RoleBinding",
                "metadata": {
                    "name": binding_name,
                    "namespace": ns,
                    "annotations": annotations,
                },
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": role,
                },
                "subjects": [subject],
            }
            set_owner(rb, profile)
            self._create_or_replace(ROLEBINDING, rb)

    # -- istio ---------------------------------------------------------------

    def _reconcile_authorization_policy(self, profile: Resource) -> None:
        ns = name_of(profile)
        owner = deep_get(profile, "spec", "owner", "name", default="")
        header_value = f"{self.userid_prefix}{owner}"
        policy = {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {"name": AUTH_POLICY_NAME, "namespace": ns},
            "spec": {
                "rules": [
                    # Owner traffic, identified by the trusted gateway header.
                    {"when": [{
                        "key": f"request.headers[{self.userid_header}]",
                        "values": [header_value],
                    }]},
                    # In-namespace traffic (sidecar-to-sidecar).
                    {"from": [{"source": {"namespaces": [ns]}}]},
                    # Culling probe: the notebook controller SA may GET the
                    # kernels API (reference :470-488).
                    {
                        "from": [{"source": {
                            "principals": [self.notebook_controller_sa],
                        }}],
                        "to": [{"operation": {
                            "methods": ["GET"],
                            "paths": ["*/api/kernels"],
                        }}],
                    },
                ]
            },
        }
        set_owner(policy, profile)
        self._create_or_replace(AUTHORIZATIONPOLICY, policy)

    # -- quota (the GPU hook) ------------------------------------------------

    def _reconcile_resource_quota(self, profile: Resource) -> None:
        ns = name_of(profile)
        spec = deep_get(profile, "spec", "resourceQuotaSpec", default={}) or {}
        if not spec.get("hard"):
            # No quota requested: remove a previously-managed one.
            try:
                self.client.delete(RESOURCEQUOTA, QUOTA_NAME, ns)
            except errors.NotFound:
                pass
            return
        quota = {
            "apiVersion": "v1",
            "kind": "ResourceQuota",
            "metadata": {"name": QUOTA_NAME, "namespace": ns},
            "spec": spec,
        }
        set_owner(quota, profile)
        self._create_or_replace(RESOURCEQUOTA, quota)

    # -- plugins -------------------------------------------------------------

    def _apply_plugins(self, profile: Resource) -> None:
        for plugin_cfg in deep_get(profile, "spec", "plugins", default=[]) or []:
            kind = plugin_cfg.get("kind", "")
            plugin = self.plugins.get(kind)
            if plugin is None:
                self.recorder.event(
                    profile, "Warning", "UnknownPlugin", f"no plugin {kind!r}"
                )
                continue
            plugin.apply(self.client, profile, plugin_cfg.get("spec", {}) or {})

    def _revoke_plugins(self, profile: Resource) -> None:
        for plugin_cfg in deep_get(profile, "spec", "plugins", default=[]) or []:
            plugin = self.plugins.get(plugin_cfg.get("kind", ""))
            if plugin is not None:
                try:
                    plugin.revoke(
                        self.client, profile, plugin_cfg.get("spec", {}) or {}
                    )
                except Exception:
                    self.recorder.event(
                        profile, "Warning", "PluginRevokeFailed",
                        f"revoke {plugin_cfg.get('kind')} failed",
                    )

    # -- status/helpers ------------------------------------------------------

    def _create_or_replace(self, gvk, desired: Resource) -> None:
        ns = deep_get(desired, "metadata", "namespace")
        name = name_of(desired)
        try:
            current = self.client.get(gvk, name, ns)
        except errors.NotFound:
            apply.create(self.client, desired)
            return
        interesting = ("spec", "roleRef", "subjects")
        if any(current.get(k) != desired.get(k) for k in interesting if k in desired):
            current.update({k: desired[k] for k in interesting if k in desired})
            self.client.update(current)

    def _set_ready(self, profile: Resource) -> None:
        self._set_status(profile, {"status": "Succeeded", "message": ""})

    def _set_failed(self, profile: Resource, message: str) -> None:
        self.recorder.event(profile, "Warning", "ProfileFailed", message,
                            namespace="default")
        self._set_status(profile, {"status": "Failed", "message": message})

    def _set_status(self, profile: Resource, status: dict) -> None:
        # Diff-and-patch the status subresource (runtime/apply.py): only
        # the changed subtree is written, conflict-free.
        from kubeflow_tpu_torch.platform.runtime.apply import patch_status_diff

        patch_status_diff(self.client, PROFILE, profile, status)


def labels_file_watcher(path: str, *, poll_seconds: float = 1.0):
    """Controller runnable: poll the namespace-labels file's mtime and
    trigger a reconcile of every Profile when it changes — the fsnotify
    watch + reconcile-all of the reference (profile_controller.go:368-399).
    mtime polling also covers the ConfigMap symlink-swap dance the
    reference handles via Remove+re-Add."""
    import logging
    import os

    def run(controller) -> None:
        from kubeflow_tpu_torch.platform.runtime import Request as Req

        def stat():
            try:
                st = os.stat(path)
                return (st.st_mtime_ns, st.st_ino)
            except OSError:
                return None

        last = stat()
        while not controller._stop.wait(poll_seconds):
            now = stat()
            if now != last:
                last = now
                try:
                    for p in controller.reconciler.client.list(PROFILE):
                        controller.queue.add(Req("", name_of(p)))
                except Exception:
                    # Transient list failure; the next file change retries.
                    logging.getLogger("kubeflow_tpu_torch.controllers.profile").debug(
                        "labels-file relist failed; next change retries",
                        exc_info=True)

    return run


def make_controller(client, *, heartbeat: bool = False, **kwargs):
    from kubeflow_tpu_torch.platform.runtime import Controller

    shards = kwargs.pop("shards", None)
    reconciler = ProfileReconciler(client, **kwargs)
    runnables = []
    if reconciler.labels_path:
        runnables.append(labels_file_watcher(reconciler.labels_path))
    return Controller(
        "profile-controller",
        reconciler,
        primary=PROFILE,
        resync_period=300.0,
        # Deliberately NO primary informer: a missing Profile CRD must
        # degrade to a retrying raw watch, not a fatal cache-sync failure
        # that takes the whole controller manager down (Controller.start
        # raises on sync timeout).  The raw watch resumes by
        # resourceVersion (_watch_loop), so re-establishments no longer
        # replay every Profile as ADDED anyway.
        runnables=runnables,
        # Heartbeat rides the controller lifecycle: stop_heartbeat on stop
        # drops the ticker AND the registry entry, so a rebuilt controller
        # (tests, leader-election restart) gets a fresh heartbeat instead
        # of the pre-fix wedged Event.
        on_start=(lambda: metrics.start_heartbeat("profile"))
        if heartbeat else None,
        on_stop=(lambda: metrics.stop_heartbeat("profile"))
        if heartbeat else None,
        shards=shards,
    )
