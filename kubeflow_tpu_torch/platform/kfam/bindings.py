"""Binding materialization: (user, namespace, role) ⇄ RoleBinding + Istio
AuthorizationPolicy.

The port's copy of ``kubeflow_tpu/platform/kfam/bindings.py``.  The
reference KFAM stores a contributor binding as a RoleBinding to
ClusterRole ``kubeflow-<role>`` plus an AuthorizationPolicy admitting the
user's trusted header (reference access-management/kfam/bindings.go).
The same pair is materialized here, named after the (sanitized) user and
role so bindings are discoverable by listing.
"""
from __future__ import annotations

import re
from typing import List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    AUTHORIZATIONPOLICY,
    PROFILE,
    ROLEBINDING,
    Resource,
    deep_get,
)

ROLES = ("admin", "edit", "view")


def _sanitize(user: str) -> str:
    return re.sub(r"[^a-z0-9]", "-", user.lower()).strip("-")


def binding_name(user: str, role: str) -> str:
    return f"user-{_sanitize(user)}-clusterrole-{role}"


class BindingManager:
    def __init__(self, client, *, userid_header: Optional[str] = None,
                 userid_prefix: Optional[str] = None, cache=None):
        """``cache`` is an optional started Informer over RoleBindings
        (reference KFAM reads through a 60-min-resync informer,
        api_default.go:94-103); queries fall back to live lists without it."""
        self.client = client
        self.cache = cache
        self.userid_header = userid_header or config.env("USERID_HEADER", "kubeflow-userid")
        self.userid_prefix = (
            userid_prefix if userid_prefix is not None else config.env("USERID_PREFIX", "")
        )

    # -- queries -------------------------------------------------------------

    def _role_bindings(self, namespace: Optional[str]) -> List[Resource]:
        # An unsynced cache would serve "no bindings" as authoritative —
        # fall back to a live list until the initial LIST has landed.
        if self.cache is not None and getattr(self.cache, "has_synced", True):
            return self.cache.list(namespace)
        return self.client.list(ROLEBINDING, namespace)

    def list_bindings(self, namespace: Optional[str] = None,
                      user: Optional[str] = None) -> List[dict]:
        out = []
        for rb in self._role_bindings(namespace):
            annotations = deep_get(rb, "metadata", "annotations", default={}) or {}
            role = annotations.get("role")
            bound_user = annotations.get("user")
            if not role or not bound_user:
                continue
            subjects = rb.get("subjects") or [{}]
            if subjects[0].get("kind") == "ServiceAccount":
                # Defensive: SA plumbing bindings are infrastructure, not
                # contributors, even if annotated by an older controller.
                continue
            if user and bound_user != user:
                continue
            out.append({
                "user": {"kind": "User", "name": bound_user},
                "referredNamespace": deep_get(rb, "metadata", "namespace"),
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": deep_get(rb, "roleRef", "name", default=""),
                },
            })
        return out

    def is_owner(self, user: str, namespace: str) -> bool:
        try:
            profile = self.client.get(PROFILE, namespace)
        except errors.NotFound:
            return False
        return deep_get(profile, "spec", "owner", "name") == user

    def is_cluster_admin(self, user: str) -> bool:
        return self.client.can_i(user, "delete", PROFILE)

    # -- mutations -----------------------------------------------------------

    def create_binding(self, user: str, namespace: str, role: str) -> None:
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        rb = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {
                "name": binding_name(user, role),
                "namespace": namespace,
                "annotations": {"role": role, "user": user},
            },
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": f"kubeflow-{role}",
            },
            "subjects": [{
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "User",
                "name": user,
            }],
        }
        try:
            self.client.create(rb)
        except errors.Conflict:
            # _sanitize can collide ('a.b@c' and 'a-b@c' share a name): only
            # tolerate the conflict when the existing binding is for the SAME
            # user; otherwise success here would silently grant nothing.
            existing = self.client.get(ROLEBINDING, binding_name(user, role), namespace)
            if deep_get(existing, "metadata", "annotations", "user") != user:
                raise errors.Conflict(
                    f"binding name {binding_name(user, role)!r} already taken "
                    f"by a different user"
                ) from None
        policy = {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {
                "name": binding_name(user, role),
                "namespace": namespace,
                "annotations": {"role": role, "user": user},
            },
            "spec": {
                "rules": [{
                    "when": [{
                        "key": f"request.headers[{self.userid_header}]",
                        "values": [f"{self.userid_prefix}{user}"],
                    }],
                }],
            },
        }
        try:
            self.client.create(policy)
        except errors.Conflict:
            pass

    def delete_binding(self, user: str, namespace: str, role: str) -> None:
        for gvk in (ROLEBINDING, AUTHORIZATIONPOLICY):
            try:
                self.client.delete(gvk, binding_name(user, role), namespace)
            except errors.NotFound:
                pass

    # -- profiles ------------------------------------------------------------

    def create_profile(self, name: str, owner: str) -> Resource:
        return self.client.create({
            "apiVersion": "kubeflow.org/v1",
            "kind": "Profile",
            "metadata": {"name": name},
            "spec": {"owner": {"kind": "User", "name": owner}},
        })

    def delete_profile(self, name: str) -> None:
        self.client.delete(PROFILE, name)
