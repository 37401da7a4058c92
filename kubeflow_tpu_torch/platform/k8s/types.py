"""Unstructured Kubernetes objects: plain dicts + typed helpers.

The port's copy of ``kubeflow_tpu/platform/k8s/types.py``: every object
is a plain ``dict`` shaped exactly like its JSON wire form, with a small
helper layer for the fields the platform touches (the GVK table,
``deep_get``, owner references), and the read-only views ``freeze`` /
``thaw`` an informer cache hands out.  Standard library only.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from typing import Any, Dict, Optional

Resource = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GVK:
    """Group/version/kind + the REST plural for the resource."""

    group: str  # "" for core
    version: str
    kind: str
    plural: str
    namespaced: bool = True

    @property
    def api_version(self) -> str:
        return self.version if not self.group else f"{self.group}/{self.version}"

    def path(self, namespace: Optional[str] = None, name: Optional[str] = None) -> str:
        root = "/api" if not self.group else "/apis"
        parts = [root, self.api_version]
        if self.namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(self.plural)
        if name:
            parts.append(name)
        return "/".join(parts)


# --- Well-known kinds -------------------------------------------------------

CORE = ""
POD = GVK(CORE, "v1", "Pod", "pods")
SERVICE = GVK(CORE, "v1", "Service", "services")
NAMESPACE = GVK(CORE, "v1", "Namespace", "namespaces", namespaced=False)
NODE = GVK(CORE, "v1", "Node", "nodes", namespaced=False)
EVENT = GVK(CORE, "v1", "Event", "events")
SECRET = GVK(CORE, "v1", "Secret", "secrets")
CONFIGMAP = GVK(CORE, "v1", "ConfigMap", "configmaps")
SERVICEACCOUNT = GVK(CORE, "v1", "ServiceAccount", "serviceaccounts")
PVC = GVK(CORE, "v1", "PersistentVolumeClaim", "persistentvolumeclaims")
RESOURCEQUOTA = GVK(CORE, "v1", "ResourceQuota", "resourcequotas")

STATEFULSET = GVK("apps", "v1", "StatefulSet", "statefulsets")
PODDISRUPTIONBUDGET = GVK("policy", "v1", "PodDisruptionBudget", "poddisruptionbudgets")
DEPLOYMENT = GVK("apps", "v1", "Deployment", "deployments")

ROLEBINDING = GVK("rbac.authorization.k8s.io", "v1", "RoleBinding", "rolebindings")
CLUSTERROLE = GVK("rbac.authorization.k8s.io", "v1", "ClusterRole", "clusterroles", namespaced=False)
STORAGECLASS = GVK("storage.k8s.io", "v1", "StorageClass", "storageclasses", namespaced=False)

LEASE = GVK("coordination.k8s.io", "v1", "Lease", "leases")

VIRTUALSERVICE = GVK("networking.istio.io", "v1beta1", "VirtualService", "virtualservices")
AUTHORIZATIONPOLICY = GVK("security.istio.io", "v1beta1", "AuthorizationPolicy", "authorizationpolicies")

NOTEBOOK = GVK("kubeflow.org", "v1beta1", "Notebook", "notebooks")
PROFILE = GVK("kubeflow.org", "v1", "Profile", "profiles", namespaced=False)
PODDEFAULT = GVK("kubeflow.org", "v1alpha1", "PodDefault", "poddefaults")
TENSORBOARD = GVK("tensorboard.kubeflow.org", "v1alpha1", "Tensorboard", "tensorboards")
TPUJOB = GVK("kubeflow.org", "v1alpha1", "TPUJob", "tpujobs")
INFERENCESERVICE = GVK("kubeflow.org", "v1alpha1", "InferenceService",
                       "inferenceservices")

WELL_KNOWN: tuple[GVK, ...] = (
    POD, SERVICE, NAMESPACE, NODE, EVENT, SECRET, CONFIGMAP, SERVICEACCOUNT,
    PVC, RESOURCEQUOTA, STATEFULSET, PODDISRUPTIONBUDGET, DEPLOYMENT,
    ROLEBINDING, CLUSTERROLE, STORAGECLASS, LEASE, VIRTUALSERVICE,
    AUTHORIZATIONPOLICY, NOTEBOOK, PROFILE, PODDEFAULT, TENSORBOARD, TPUJOB,
    INFERENCESERVICE,
)


def pluralize(kind: str) -> str:
    """Conventional REST plural for a kind, lowercased: the same rules
    kubebuilder's flect applies for CRDs — ``y`` after a consonant becomes
    ``ies`` (NetworkPolicy → networkpolicies), sibilant endings take
    ``es`` (Ingress → ingresses, Status → statuses), and a kind that is
    already plural (bare ``s``: Endpoints) passes through unchanged;
    everything else appends ``s``."""
    lower = kind.lower()
    if lower.endswith("y") and len(lower) > 1 and lower[-2] not in "aeiou":
        return lower[:-1] + "ies"
    if lower.endswith(("ss", "us", "is", "x", "z", "ch", "sh")):
        return lower + "es"
    if lower.endswith("s"):
        return lower  # already plural (Endpoints → endpoints)
    return lower + "s"


def gvk_for(api_version: str, kind: str) -> GVK:
    for g in WELL_KNOWN:
        if g.api_version == api_version and g.kind == kind:
            return g
    group, _, version = api_version.rpartition("/")
    # Fall back to the conventional lowercase-plural guess.
    return GVK(group, version or api_version, kind, pluralize(kind))


# --- Object helpers ---------------------------------------------------------


def new(gvk: GVK, name: str, namespace: Optional[str] = None, *,
        labels: Optional[dict] = None, annotations: Optional[dict] = None) -> Resource:
    obj: Resource = {
        "apiVersion": gvk.api_version,
        "kind": gvk.kind,
        "metadata": {"name": name},
    }
    if gvk.namespaced and namespace:
        obj["metadata"]["namespace"] = namespace
    if labels:
        obj["metadata"]["labels"] = dict(labels)
    if annotations:
        obj["metadata"]["annotations"] = dict(annotations)
    return obj


def meta(obj: Resource) -> dict:
    m = obj.get("metadata")
    if m is not None:
        return m
    if type(obj) is dict:
        return obj.setdefault("metadata", {})
    # Read-only view without metadata: hand back a FROZEN empty mapping —
    # a detached plain {} would swallow writes silently, where the whole
    # contract is that a write without thaw() fails loudly.
    return FrozenResource({})


def name_of(obj: Resource) -> str:
    return meta(obj).get("name", "")


def namespace_of(obj: Resource) -> Optional[str]:
    return meta(obj).get("namespace")


def api_version_of(obj: Resource) -> str:
    return obj.get("apiVersion", "")


def gvk_of(obj: Resource) -> GVK:
    return gvk_for(api_version_of(obj), obj.get("kind", ""))


def labels_of(obj: Resource) -> dict:
    return meta(obj).get("labels") or {}


def annotations_of(obj: Resource) -> dict:
    return meta(obj).get("annotations") or {}


def set_annotation(obj: Resource, key: str, value: str) -> None:
    meta(obj).setdefault("annotations", {})[key] = value


def owner_reference(owner: Resource, *, controller: bool = True,
                    block_owner_deletion: bool = True) -> dict:
    return {
        "apiVersion": api_version_of(owner),
        "kind": owner.get("kind", ""),
        "name": name_of(owner),
        "uid": meta(owner).get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": block_owner_deletion,
    }


def set_owner(obj: Resource, owner: Resource) -> None:
    refs = meta(obj).setdefault("ownerReferences", [])
    ref = owner_reference(owner)
    for existing in refs:
        if existing.get("uid") == ref["uid"] and existing.get("name") == ref["name"]:
            return
    refs.append(ref)


def is_owned_by(obj: Resource, owner: Resource) -> bool:
    owner_uid = meta(owner).get("uid")
    return any(r.get("uid") == owner_uid for r in meta(obj).get("ownerReferences", []))


def controller_of(obj: Resource) -> Optional[dict]:
    for r in meta(obj).get("ownerReferences", []):
        if r.get("controller"):
            return r
    return None


def match_labels(obj: Resource, selector: Dict[str, str]) -> bool:
    labels = labels_of(obj)
    return all(labels.get(k) == v for k, v in selector.items())


def deep_get(obj: Resource, *path: str, default: Any = None) -> Any:
    cur: Any = obj
    for p in path:
        if type(cur) is not dict and not isinstance(cur, Mapping):
            return default
        if p not in cur:
            return default
        cur = cur[p]
    return cur


def pod_ready(pod: Resource) -> bool:
    """True when the pod's Ready condition is True — the readiness read
    every controller aggregates worker status from."""
    for cond in deep_get(pod, "status", "conditions", default=[]):
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def parse_timestamp(value) -> "float | None":
    """ISO-8601 Kubernetes timestamp → epoch seconds (UTC); None on
    junk.  Accepts the apiserver's ``Z`` form with or without fractional
    seconds plus numeric offsets — the ONE implementation for every
    epoch-seconds consumer (jobqueue queue-wait ages, the notebook
    spawn-latency histogram; culling keeps its datetime-returning
    variant for tz-aware comparisons)."""
    if not value:
        return None
    import datetime

    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S.%fZ",
                "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S.%f%z"):
        try:
            dt = datetime.datetime.strptime(value, fmt)
        except (ValueError, TypeError):
            continue
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        return dt.timestamp()
    return None


def copy_resource(x: Any) -> Any:
    """Deep copy for JSON-shaped resources (dict/list/scalars — the only
    shapes k8s objects hold; they all cross the wire as JSON).  ~5x faster
    than copy.deepcopy, which pays memoization and reflective dispatch this
    data never needs.  Frozen views (FrozenResource/FrozenList) copy their
    backing data, so the result is always plain and mutable.  An unexpected
    node type falls back to copy.deepcopy for that subtree."""
    t = type(x)
    if t is dict:
        return {k: copy_resource(v) for k, v in x.items()}
    if t is list:
        return [copy_resource(v) for v in x]
    if t is str or t is int or t is float or t is bool or x is None:
        return x
    if t is FrozenResource or t is FrozenList:
        return copy_resource(x._data)
    import copy

    return copy.deepcopy(x)


# --- Zero-copy read-only views ----------------------------------------------
#
# Informer caches used to deep-copy every get/list/index_list result so a
# caller mutation couldn't corrupt the shared store — O(fleet × object
# size) allocations per resync wave, the control plane's dominant cost at
# scale (bench_scale.py).  client-go solves this by CONTRACT (informer
# objects are shared and must not be mutated); Python callers can't be
# trusted by convention alone, so the contract is enforced: cached reads
# return FrozenResource/FrozenList wrappers over the live cache objects
# (zero copies), any mutation attempt raises TypeError, and a caller that
# actually intends to write calls thaw(obj) for a private mutable deep
# copy — controller-runtime's DeepCopy-on-intent-to-write, made explicit.

_READONLY_MSG = "cached object is read-only; call thaw()"


class FrozenResource(Mapping):
    """Recursive read-only Mapping view over a cached dict.  Container
    values are wrapped lazily on access, so an untouched subtree costs
    nothing.  Equality follows Mapping semantics (== any Mapping with
    equal items, including plain dicts)."""

    __slots__ = ("_data",)

    def __init__(self, data: dict):
        self._data = data

    def __getitem__(self, key):
        return freeze(self._data[key])

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key, default=None):
        if key in self._data:
            return freeze(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def __repr__(self) -> str:
        return f"FrozenResource({self._data!r})"

    def __deepcopy__(self, memo):
        # A deep copy of a read-only view is a private copy; mutability is
        # the point of taking one (same result as thaw()).
        return copy_resource(self._data)

    # -- mutation surface: refuse loudly --------------------------------------

    def _readonly(self, *_a, **_k):
        raise TypeError(_READONLY_MSG)

    __setitem__ = __delitem__ = _readonly
    setdefault = update = pop = popitem = clear = _readonly


class FrozenList(Sequence):
    """Recursive read-only Sequence view over a cached list."""

    __slots__ = ("_data",)

    def __init__(self, data: list):
        self._data = data

    def __getitem__(self, index):
        if isinstance(index, slice):
            return FrozenList(self._data[index])
        return freeze(self._data[index])

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return (freeze(v) for v in self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, FrozenList):
            return self._data == other._data
        # Lists only, mirroring plain-list semantics exactly: a frozen
        # view must never compare equal to a tuple its thawed twin
        # wouldn't (['a'] == ('a',) is False).
        if isinstance(other, list):
            return len(self._data) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None

    def __repr__(self) -> str:
        return f"FrozenList({self._data!r})"

    def __deepcopy__(self, memo):
        return copy_resource(self._data)

    def _readonly(self, *_a, **_k):
        raise TypeError(_READONLY_MSG)

    __setitem__ = __delitem__ = _readonly
    append = extend = insert = remove = pop = clear = sort = reverse = _readonly
    __iadd__ = __imul__ = _readonly


def freeze(x: Any) -> Any:
    """Read-only view of a JSON-shaped value; scalars pass through, an
    already-frozen view is returned as-is.  O(1) — no copying."""
    t = type(x)
    if t is dict:
        return FrozenResource(x)
    if t is list:
        return FrozenList(x)
    return x


def thaw(x: Any) -> Any:
    """Private mutable deep copy of a (possibly frozen) resource — the
    explicit intent-to-write step of the read-ownership contract.  Safe on
    plain dicts too (REST reads are already private), so call sites behave
    identically whether their read came from a cache or the wire."""
    t = type(x)
    if t is FrozenResource or t is FrozenList:
        return copy_resource(x._data)
    return copy_resource(x)


def json_default(o: Any) -> Any:
    """``json.dumps(..., default=json_default)`` hook: serialize frozen
    views by handing the encoder their backing data — a read-modify-write
    round trip never copies just to cross the wire."""
    if type(o) is FrozenResource or type(o) is FrozenList:
        return o._data
    raise TypeError(
        f"Object of type {type(o).__name__} is not JSON serializable")
