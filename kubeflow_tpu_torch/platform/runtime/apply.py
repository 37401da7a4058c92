"""create-or-update with content-hash ownership, on a patch-minimal wire.
The port's copy of ``kubeflow_tpu/platform/runtime/apply.py``, whose
merge-patch diff is the Python walk alone (the reference's native
engine is not ported).

Raw subtree equality between a generated spec and the live object is
always-false against a real API server (server-side defaulting), so every
reconcile would rewrite the object.  Instead the controller stamps a hash of
what it generated; updates happen only when the *generated* content changes
— the Deployment pod-template-hash idiom, shared by all controllers here
(the reference's reconcilehelper/util.go solves this with per-kind semantic
field copies; a hash is kind-agnostic).

Write minimization: when the hash HAS changed, the write is a JSON merge
patch of the diff between the live owned fields and the generated ones
(``merge_patch_for``), not a full-object PUT — fewer bytes on the wire,
and no resourceVersion precondition, so the write cannot 409 against
concurrent status/metadata churn (the conflict storm chaos testing
surfaced on the full-update path).  Status writers share the same diff
through ``patch_status_diff``.  Caveat, documented in
docs/performance.md: a diff against the LIVE subtree emits null removal
markers for keys the generator doesn't set — inside controller-authored
subtrees that is exactly right (it is how a removed env var actually gets
removed), and server-DEFAULTED keys the markers touch are simply
re-defaulted by the apiserver on apply.
"""
from __future__ import annotations

import copy
import hashlib
import json
import time
from typing import Any, Iterable, Optional

from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import GVK, Resource, deep_get, gvk_of, meta, name_of, namespace_of
from kubeflow_tpu_torch.telemetry import causal

HASH_ANNOTATION = "kubeflow.org/generated-hash"

# Sentinel distinguishing "no change" from "the change is null/removal".
_UNCHANGED = object()


def _timed_write(verb: str, kind: str, name: str, fn):
    """Run one client write, recording its round trip as a ``write_rtt``
    span on the current causal journey (telemetry/causal.py) — failed
    writes record too (ok=False): a journey showing where a reconcile
    burned its retries is the point."""
    t0 = time.time()
    try:
        out = fn()
    except Exception:
        causal.record_write(verb, kind, name, t0, ok=False)
        raise
    causal.record_write(verb, kind, name, t0)
    return out


def create(client, desired: Resource) -> Resource:
    """Context-stamping create: the sanctioned way for a reconciler to
    create a child object.  Stamps the child with the
    reconcile's causal context — a Notebook's StatefulSets, a TPUJob's
    gang, an InferenceService's revisions all inherit the parent's
    trace — and records the write RTT on the journey.  Exceptions
    (AlreadyExists and friends) propagate exactly like ``client.create``,
    so existing fallback logic keeps its shape."""
    causal.stamp_child(desired)
    gvk = gvk_of(desired)
    return _timed_write("create", gvk.kind, name_of(desired),
                        lambda: client.create(desired))


def content_hash(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]


def _diff(current: Any, desired: Any) -> Any:
    """The RFC 7386 merge patch transforming ``current`` into ``desired``,
    or _UNCHANGED when they are already equal.  Dicts diff recursively
    (keys present in current but absent from desired become null removal
    markers); lists — like RFC 7386 itself — replace wholesale.  Accepts
    frozen cache views on the ``current`` side (Mapping equality), so
    callers diff straight off the informer without thawing."""
    from collections.abc import Mapping

    cur_is_map = isinstance(current, Mapping)
    if cur_is_map and isinstance(desired, dict):
        patch = {}
        for key, want in desired.items():
            if key in current:
                sub = _diff(current[key], want)
                if sub is not _UNCHANGED:
                    patch[key] = sub
            else:
                patch[key] = copy.deepcopy(want)
        for key in current:
            if key not in desired:
                patch[key] = None
        return patch if patch else _UNCHANGED
    if current == desired:
        return _UNCHANGED
    return copy.deepcopy(desired)


def merge_patch_for(current: Any, desired: Any) -> Optional[dict]:
    """Minimal JSON merge patch turning ``current`` into ``desired`` —
    ``None`` when nothing differs.  Top level must be mappings (merge
    patches are objects)."""
    patch = _diff(current or {}, desired or {})
    if patch is _UNCHANGED:
        return None
    return patch


def patch_status_diff(client, gvk: GVK, obj: Resource,
                      desired_status: dict) -> bool:
    """Diff-and-patch the status subresource: compute the merge patch of
    ``obj``'s current status against ``desired_status`` and PATCH only the
    changed subtree.  Returns True when a write happened.  Falls back to a
    full ``update_status`` for clients that predate ``patch_status`` (test
    doubles), preserving behavior."""
    diff = merge_patch_for(obj.get("status") or {}, desired_status)
    if diff is None:
        return False
    patcher = getattr(client, "patch_status", None)
    if patcher is not None:
        _timed_write(
            "patch_status", gvk.kind, name_of(obj),
            lambda: patcher(gvk, name_of(obj), {"status": diff},
                            namespace_of(obj)))
        return True
    full = copy.deepcopy(obj)
    full["status"] = desired_status
    _timed_write("update_status", gvk.kind, name_of(obj),
                 lambda: client.update_status(full))
    return True


def create_or_update(
    client,
    gvk: GVK,
    desired: Resource,
    *,
    owned_fields: Iterable[str] = ("spec",),
    hash_annotation: str = HASH_ANNOTATION,
) -> Resource:
    """Create the object, or — when the generated content hash changed —
    merge-patch its owned fields back to the generated state.  Server-
    populated fields outside ``owned_fields`` survive untouched; the
    steady-state reconcile (hash unchanged) writes nothing at all."""
    owned = {k: desired[k] for k in owned_fields if k in desired}
    desired_hash = content_hash(owned)
    meta(desired).setdefault("annotations", {})[hash_annotation] = desired_hash
    # Causal journey (telemetry/causal.py): the child inherits the
    # reconcile's trace context.  Stamped OUTSIDE the hash (annotations
    # are not owned fields), and restamped on every content change so
    # each generation of a child links to the reconcile that caused it.
    causal.stamp_child(desired)
    ns = meta(desired).get("namespace")
    name = name_of(desired)
    try:
        current = client.get(gvk, name, ns)
    except errors.NotFound:
        return _timed_write("create", gvk.kind, name,
                            lambda: client.create(desired))
    if deep_get(current, "metadata", "annotations", hash_annotation) == desired_hash:
        return current
    patcher = getattr(client, "patch", None)
    if patcher is not None:
        patch: dict = {
            "metadata": {"annotations": {
                hash_annotation: desired_hash,
                **causal.annotations_of(desired),
            }}}
        for k, v in owned.items():
            sub = merge_patch_for(current.get(k), v)
            if sub is not None:
                patch[k] = sub
        return _timed_write("patch", gvk.kind, name,
                            lambda: patcher(gvk, name, patch, ns))
    # Legacy full-update path for clients without patch (test doubles).
    current = copy.deepcopy(current)
    for k, v in owned.items():
        current[k] = v
    meta(current).setdefault("annotations", {})[hash_annotation] = desired_hash
    meta(current)["annotations"].update(causal.annotations_of(desired))
    return _timed_write("update", gvk.kind, name,
                        lambda: client.update(current))
