"""PodDefault mutation: merge PodDefault specs into pods at admission.
The port's copy of ``kubeflow_tpu/platform/webhook/mutate.py``; the patch
is ``jsonpatch.create_patch_fast``'s (the native engine's diff, or the
Python one).

Semantics follow the reference webhook exactly (reference
admission-webhook/main.go): selection by label selector (:70-95), the
conflict-or-identical rule on name collisions for env/volumes/mounts/
containers/tolerations (:215-448), command/args only-if-unset (:580-595),
istio-proxy containers skipped, exclusion annotation honored, and a
provenance annotation per applied PodDefault (:551-553).

The GPU angle: a PodDefault is how the GPU runtime's env and mounts
reach *arbitrary* pods in a namespace — e.g. a ``gpu-h100-80gb``
PodDefault (``apis/poddefault.py``) selected by the spawner's
configurations checklist injects ``KFT_GPUS_PER_HOST`` and a
memory-backed /dev/shm without the pod spec knowing about GPUs.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

from kubeflow_tpu_torch.platform.k8s.types import Resource, deep_get, meta, name_of

EXCLUDE_ANNOTATION = "poddefault.admission.kubeflow.org/exclude"
PROVENANCE_PREFIX = "poddefault.admission.kubeflow.org/poddefault-"
MIRROR_ANNOTATION = "kubernetes.io/config.mirror"
ISTIO_PROXY = "istio-proxy"


class MergeConflict(Exception):
    pass


# -- selection ---------------------------------------------------------------


def selector_matches(selector: dict, labels: Dict[str, str]) -> bool:
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "")
        values = expr.get("values") or []
        if op == "In" and labels.get(key) not in values:
            return False
        if op == "NotIn" and labels.get(key) in values:
            return False
        if op == "Exists" and key not in labels:
            return False
        if op == "DoesNotExist" and key in labels:
            return False
    return True


def filter_pod_defaults(pod_defaults: List[Resource], pod: Resource) -> List[Resource]:
    annotations = deep_get(pod, "metadata", "annotations", default={}) or {}
    if annotations.get(EXCLUDE_ANNOTATION) == "true":
        return []
    if MIRROR_ANNOTATION in annotations:
        return []
    labels = deep_get(pod, "metadata", "labels", default={}) or {}
    out = []
    for pd in pod_defaults:
        selector = deep_get(pd, "spec", "selector", default={}) or {}
        if selector_matches(selector, labels):
            out.append(pd)
    return sorted(out, key=name_of)


# -- merge helpers (conflict-or-identical) -----------------------------------


def _merge_named(existing: List[dict], incoming: List[dict], what: str,
                 key: str = "name") -> List[dict]:
    by_key = {e.get(key): e for e in existing}
    out = list(existing)
    for item in incoming or []:
        k = item.get(key)
        if k in by_key:
            if by_key[k] != item:
                raise MergeConflict(
                    f"{what} {k!r} already exists with a different definition"
                )
            continue
        out.append(copy.deepcopy(item))
        by_key[k] = item
    return out


def _merge_tolerations(existing: List[dict], incoming: List[dict]) -> List[dict]:
    out = list(existing)
    for tol in incoming or []:
        if tol in out:
            continue
        if any(t.get("key") == tol.get("key") and t != tol for t in out):
            raise MergeConflict(
                f"toleration key {tol.get('key')!r} conflicts with an existing one"
            )
        out.append(copy.deepcopy(tol))
    return out


def _merge_map(existing: Dict[str, str], incoming: Dict[str, str], what: str) -> Dict[str, str]:
    out = dict(existing)
    for k, v in (incoming or {}).items():
        if k in out and out[k] != v:
            raise MergeConflict(f"{what} {k!r} conflicts ({out[k]!r} != {v!r})")
        out[k] = v
    return out


# -- apply -------------------------------------------------------------------


def _app_containers(pod_spec: dict) -> List[dict]:
    return [
        c for c in pod_spec.get("containers", []) if c.get("name") != ISTIO_PROXY
    ]


def apply_pod_defaults(pod: Resource, pod_defaults: List[Resource]) -> Resource:
    """Return a mutated deep copy; raises MergeConflict when unsafe."""
    pod = copy.deepcopy(pod)
    spec = pod.setdefault("spec", {})
    annotations = meta(pod).setdefault("annotations", {})
    labels = meta(pod).setdefault("labels", {})

    for pd in pod_defaults:
        pspec = pd.get("spec", {})
        for container in _app_containers(spec):
            container["env"] = _merge_named(
                container.get("env", []), pspec.get("env"), "env var"
            )
            if pspec.get("envFrom"):
                container["envFrom"] = container.get("envFrom", []) + copy.deepcopy(
                    pspec["envFrom"]
                )
            container["volumeMounts"] = _merge_named(
                container.get("volumeMounts", []), pspec.get("volumeMounts"),
                "volume mount",
            )
            if pspec.get("command") and not container.get("command"):
                container["command"] = copy.deepcopy(pspec["command"])
            if pspec.get("args") and not container.get("args"):
                container["args"] = copy.deepcopy(pspec["args"])
        spec["volumes"] = _merge_named(
            spec.get("volumes", []), pspec.get("volumes"), "volume"
        )
        if pspec.get("initContainers"):
            spec["initContainers"] = _merge_named(
                spec.get("initContainers", []), pspec["initContainers"],
                "init container",
            )
        if pspec.get("sidecars"):
            spec["containers"] = _merge_named(
                spec.get("containers", []), pspec["sidecars"], "sidecar container"
            )
        if pspec.get("tolerations"):
            spec["tolerations"] = _merge_tolerations(
                spec.get("tolerations", []), pspec["tolerations"]
            )
        if pspec.get("serviceAccountName") and not spec.get("serviceAccountName"):
            spec["serviceAccountName"] = pspec["serviceAccountName"]
        if "automountServiceAccountToken" in pspec:
            spec["automountServiceAccountToken"] = pspec["automountServiceAccountToken"]
        if pspec.get("imagePullSecrets"):
            spec["imagePullSecrets"] = _merge_named(
                spec.get("imagePullSecrets", []), pspec["imagePullSecrets"],
                "image pull secret",
            )
        new_labels = _merge_map(labels, pspec.get("labels", {}), "label")
        labels.clear()
        labels.update(new_labels)
        new_annotations = _merge_map(
            annotations, pspec.get("annotations", {}), "annotation"
        )
        annotations.clear()
        annotations.update(new_annotations)
        annotations[PROVENANCE_PREFIX + name_of(pd)] = (
            deep_get(pd, "metadata", "resourceVersion", default="") or ""
        )
    return pod


def safe_to_apply(pod: Resource, pod_defaults: List[Resource]) -> Optional[str]:
    """None if the merge would succeed, else the conflict message
    (reference safeToApplyPodDefaultsOnPod, main.go:97-148)."""
    try:
        apply_pod_defaults(pod, pod_defaults)
        return None
    except MergeConflict as e:
        return str(e)


# -- admission review --------------------------------------------------------


def mutate_admission_review(review: Resource, pod_defaults: List[Resource]) -> Resource:
    """AdmissionReview(request) → AdmissionReview(response) with JSONPatch."""
    import base64
    import json

    from kubeflow_tpu_torch.platform.webhook.jsonpatch import (
        create_patch_fast as create_patch,
    )

    request = review.get("request", {}) or {}
    uid = request.get("uid", "")

    def respond(allowed: bool, *, patch: Optional[list] = None,
                message: str = "") -> Resource:
        response: dict = {"uid": uid, "allowed": allowed}
        if patch is not None and patch:
            response["patch"] = base64.b64encode(
                json.dumps(patch).encode()
            ).decode()
            response["patchType"] = "JSONPatch"
        if message:
            response["status"] = {"message": message}
        return {
            "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
            "kind": "AdmissionReview",
            "response": response,
        }

    if request.get("resource", {}).get("resource") != "pods":
        return respond(True)
    pod = request.get("object", {}) or {}
    selected = filter_pod_defaults(pod_defaults, pod)
    if not selected:
        return respond(True)
    conflict = safe_to_apply(pod, selected)
    if conflict:
        # Like the reference: refuse to mutate but do NOT block the pod.
        return respond(True, message=f"skipping PodDefaults: {conflict}")
    mutated = apply_pod_defaults(pod, selected)
    return respond(True, patch=create_patch(pod, mutated))
