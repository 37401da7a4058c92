"""In-memory Kubernetes API: the envtest analogue.

The port's copy of ``kubeflow_tpu/platform/testing/fake.py``
(``FakeKube``) with ``add_gpu_node`` in place of ``add_tpu_node``.  An
in-memory store that implements the KubeClient
protocol with the API-server semantics the controllers rely on:

* resourceVersion bumping + optimistic-concurrency conflicts on update
* status as a separate subresource (update doesn't clobber status and
  update_status doesn't clobber spec)
* uid/creationTimestamp/generation defaulting on create
* label-selector list/watch, and the shard filter of the sharded
  controller runtime on list and watch (``runtime/sharding.py``
  ``ShardFilter``: the server drops what a replica's subscription does
  not cover before it crosses the stream)
* watch streams with sequenced events per (gvk, namespace)
* ownerReference cascade deletion (synchronous — deterministic for tests)
* namespace existence checks and a pluggable SubjectAccessReview policy
* ResourceQuota admission: pod creation exceeding a namespace quota's
  ``spec.hard`` (``nvidia.com/gpu``, cpu, memory, pods) is rejected with
  the apiserver's 403 phrasing, ``status.used`` is kept current, and
  capacity is released on delete / terminal phase — the quota plugin of
  a real apiserver.  Math lives in ``k8s/quota.py``.

Plus test-only helpers: ``set_pod_phase`` to simulate kubelet, and node
fixtures with GPU capacity (``add_gpu_node``).
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import quota as quota_mod
from kubeflow_tpu_torch.platform.runtime.sharding import ShardFilter
from kubeflow_tpu_torch.platform.k8s.types import (
    GVK,
    NAMESPACE,
    POD,
    Resource,
    copy_resource as _copy_obj,
    deep_get,
    gvk_of,
    match_labels,
    meta,
    name_of,
    namespace_of,
)

Key = Tuple[str, str, str, str]  # (api_version, kind, namespace, name)


def _key(gvk: GVK, namespace: Optional[str], name: str) -> Key:
    return (gvk.api_version, gvk.kind, namespace or "", name)


class _Store(Dict[Key, Resource]):
    """Key→Resource dict with a per-(apiVersion, kind) secondary index so
    list and watch-backlog scans touch only same-kind objects.  Without it
    every LIST iterated every object of every kind — O(total store) per
    call, which bench_scale.py measured as quadratic across a fleet wave."""

    def __init__(self):
        super().__init__()
        self.by_kind: Dict[Tuple[str, str], Dict[Key, Resource]] = {}

    def __setitem__(self, key: Key, value: Resource) -> None:
        super().__setitem__(key, value)
        self.by_kind.setdefault((key[0], key[1]), {})[key] = value

    def __delitem__(self, key: Key) -> None:
        super().__delitem__(key)
        bucket = self.by_kind.get((key[0], key[1]))
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del self.by_kind[(key[0], key[1])]

    def kind_items(self, gvk: GVK):
        return self.by_kind.get((gvk.api_version, gvk.kind), {}).items()


class FakeKube:
    """KubeClient backed by a dict.  Thread-safe."""

    # Server-side shard filtering (runtime/sharding.py ShardFilter): a
    # watcher/lister may subscribe to a shard range and this server
    # filters BEFORE the event crosses the stream — the informer
    # feature-detects this flag before passing ``shard_filter``.
    supports_shard_filter = True

    def __init__(self, *, now: Optional[Callable[[], float]] = None):
        self._objects: _Store = _Store()
        self._lock = threading.RLock()
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self._watchers: List[tuple] = []  # (gvk, ns, sel, shard_filter, q)
        # kind -> events broadcast (before any shard filter): what an
        # unfiltered replica would have had to decode.
        self.events_emitted: Dict[str, int] = {}
        self._now = now or time.time
        self._latest_rv = "0"  # collection resourceVersion (see list_with_rv)
        # Watch-event replay window: (rv, event_type, shared copy), oldest
        # first; _history_floor is the newest rv already evicted (resumes
        # at or below it answer 410-style ERROR, like a compacted etcd).
        self._history: "collections.deque" = collections.deque()
        self._history_floor = 0
        # SubjectAccessReview policy: (user, verb, gvk, namespace) -> bool.
        self.authz_policy: Optional[Callable[..., bool]] = None
        # (namespace, pod, container|None) -> log text (see set_pod_logs).
        self._pod_logs: Dict[Tuple[str, str, Optional[str]], str] = {}

    # -- helpers -------------------------------------------------------------

    def _bump(self, obj: Resource) -> None:
        self._latest_rv = str(next(self._rv))
        meta(obj)["resourceVersion"] = self._latest_rv

    # Bounded watch-event history for resourceVersion resume (the etcd
    # window a real apiserver replays from; older RVs get 410 Gone).  The
    # size bounds memory; 8192 events cover multiple full reconcile passes
    # of a 1000-notebook fleet (bench_scale.py).
    WATCH_HISTORY = 8192

    def _emit(self, event_type: str, obj: Resource) -> None:
        if event_type == "DELETED":
            # A deletion is a store mutation: it gets its own RV, like the
            # real apiserver — a watcher resuming at the pre-delete RV must
            # be able to see the delete in the replay window.
            self._bump(obj)
        shared = _copy_obj(obj)
        self._history.append(
            (int(meta(shared).get("resourceVersion", 0) or 0),
             event_type, shared)
        )
        while len(self._history) > self.WATCH_HISTORY:
            rv_int, _, _ = self._history.popleft()
            self._history_floor = rv_int
        gvk = gvk_of(obj)
        self.events_emitted[gvk.kind] = (
            self.events_emitted.get(gvk.kind, 0) + 1)
        for (wgvk, wns, wsel, wfilt, q) in list(self._watchers):
            if wgvk.kind != gvk.kind or wgvk.api_version != gvk.api_version:
                continue
            if wns and namespace_of(obj) != wns:
                continue
            if wsel and not match_labels(obj, wsel):
                continue
            if wfilt is not None and not wfilt.admits(shared):
                continue
            q.put((event_type, _copy_obj(shared)))

    def _get_ref(self, gvk: GVK, name: str, namespace: Optional[str]) -> Resource:
        try:
            return self._objects[_key(gvk, namespace if gvk.namespaced else None, name)]
        except KeyError:
            raise errors.NotFound(
                f'{gvk.plural} "{name}" not found'
                + (f' in namespace "{namespace}"' if namespace else "")
            ) from None

    # -- verbs ---------------------------------------------------------------

    def get(self, gvk: GVK, name: str, namespace: Optional[str] = None) -> Resource:
        with self._lock:
            return _copy_obj(self._get_ref(gvk, name, namespace))

    def list(self, gvk, namespace=None, *, label_selector=None,
             field_selector=None, shard_filter=None) -> List[Resource]:
        filt = ShardFilter.parse(shard_filter) if isinstance(
            shard_filter, str) else shard_filter
        with self._lock:
            out = []
            for (_, _, ns, _), obj in self._objects.kind_items(gvk):
                if gvk.namespaced and namespace and ns != namespace:
                    continue
                if label_selector and not match_labels(obj, label_selector):
                    continue
                if field_selector and not _match_fields(obj, field_selector):
                    continue
                if filt is not None and not filt.admits(obj):
                    continue
                out.append(_copy_obj(obj))
            return out

    def list_with_rv(self, gvk, namespace=None, *, shard_filter=None):
        """List plus the collection resourceVersion, like the real server's
        listMeta.resourceVersion.  The RV is GLOBAL even for a
        shard-filtered (ranged) list — a watch resumed from it must not
        miss other shards' events."""
        with self._lock:
            return (self.list(gvk, namespace, shard_filter=shard_filter),
                    self._latest_rv)

    def create(self, obj: Resource, *, dry_run: bool = False) -> Resource:
        from kubeflow_tpu_torch.telemetry import causal

        with self._lock:
            obj = _copy_obj(obj)
            # First-admission minting, same rule as RestKubeClient: a
            # context-free platform CR gets its journey root here (the
            # caller's current context — e.g. an HttpKube-extracted
            # traceparent header — is inherited when set).
            causal.mint_on_admission(obj)
            gvk = gvk_of(obj)
            name = name_of(obj)
            ns = namespace_of(obj)
            if not name:
                gen = meta(obj).get("generateName")
                if not gen:
                    raise errors.Invalid("name or generateName required")
                name = gen + f"{next(self._uid):05x}"
                meta(obj)["name"] = name
            if gvk.namespaced:
                if not ns:
                    raise errors.Invalid(f"{gvk.kind} requires a namespace")
                if _key(NAMESPACE, None, ns) not in self._objects:
                    raise errors.NotFound(f'namespaces "{ns}" not found')
            key = _key(gvk, ns if gvk.namespaced else None, name)
            if key in self._objects:
                raise errors.AlreadyExists(f'{gvk.plural} "{name}" already exists')
            # Quota admission runs for dry-run too (the real apiserver's
            # dry-run executes admission plugins without persisting), so any
            # client that dry-run-creates a POD sees the denial.  NB: the
            # spawner dry-runs a Notebook CR, which this plugin ignores —
            # its user-facing quota 403 comes from _quota_preflight in
            # apps/jupyter/app.py, not from here.
            totals = None
            if gvk.kind == "Pod" and gvk.api_version == "v1":
                self._validate_pod_quantities(obj)
                totals = self._admit_pod_quota(obj, ns)
            if gvk.kind == "ResourceQuota":
                self._validate_quota(obj)
            if dry_run:
                return obj
            m = meta(obj)
            m.setdefault("uid", f"uid-{next(self._uid)}")
            m.setdefault("creationTimestamp", self._timestamp())
            m.setdefault("generation", 1)
            m.setdefault("labels", m.get("labels", {}))
            self._bump(obj)
            self._objects[key] = obj
            self._emit("ADDED", obj)
            if gvk.kind == "Pod":
                # Admission already summed the namespace: reuse its totals
                # (plus this pod) instead of re-listing.
                if totals is not None:
                    totals = quota_mod.add_usage(
                        totals, quota_mod.pod_quota_usage(obj))
                self._requota(ns, totals=totals)
            elif gvk.kind == "ResourceQuota":
                self._requota(ns)
            return _copy_obj(obj)

    def update(self, obj: Resource) -> Resource:
        with self._lock:
            gvk = gvk_of(obj)
            current = self._get_ref(gvk, name_of(obj), namespace_of(obj))
            self._check_rv(obj, current)
            obj = _copy_obj(obj)
            if gvk.kind == "ResourceQuota":
                self._validate_quota(obj)
            if gvk.kind == "Pod" and gvk.api_version == "v1":
                self._validate_pod_quantities(obj)
                self._admit_pod_change(obj, current)
            # status is a subresource: PUT on the main resource keeps it.
            if "status" in current:
                obj["status"] = _copy_obj(current["status"])
            if obj.get("spec") != current.get("spec"):
                meta(obj)["generation"] = meta(current).get("generation", 1) + 1
            else:
                meta(obj)["generation"] = meta(current).get("generation", 1)
            for field in ("uid", "creationTimestamp"):
                meta(obj)[field] = meta(current).get(field)
            if meta(current).get("deletionTimestamp"):
                meta(obj)["deletionTimestamp"] = meta(current)["deletionTimestamp"]
            self._bump(obj)
            key = _key(gvk, namespace_of(obj) if gvk.namespaced else None, name_of(obj))
            # A terminating object whose last finalizer was removed is gone.
            if meta(obj).get("deletionTimestamp") and not meta(obj).get("finalizers"):
                del self._objects[key]
                self._emit("DELETED", obj)
                self._cascade(meta(obj).get("uid"))
                if gvk.kind == "Pod":
                    self._requota(namespace_of(obj))
                return _copy_obj(obj)
            self._objects[key] = obj
            self._emit("MODIFIED", obj)
            if gvk.kind in ("Pod", "ResourceQuota"):
                self._requota(namespace_of(obj))
            return _copy_obj(obj)

    def update_status(self, obj: Resource) -> Resource:
        with self._lock:
            gvk = gvk_of(obj)
            current = self._get_ref(gvk, name_of(obj), namespace_of(obj))
            self._check_rv(obj, current)
            current["status"] = _copy_obj(obj.get("status", {}))
            self._bump(current)
            self._emit("MODIFIED", current)
            if gvk.kind == "Pod":
                # Terminal phases (Succeeded/Failed) release quota.
                self._requota(namespace_of(current))
            return _copy_obj(current)

    def patch(self, gvk, name, patch, namespace=None, *, patch_type="merge") -> Resource:
        with self._lock:
            # Accept patches that embed frozen cache views (copy_resource
            # unwraps them to plain data) — the merge and jsonpatch only
            # speak dict/list.
            patch = _copy_obj(patch)
            current = self._get_ref(gvk, name, namespace)
            # The merge below mutates the stored object in place; keep a
            # rollback copy so a post-merge validation failure (malformed
            # quota or pod quantities, over-quota resize) leaves the store
            # untouched.
            rollback = _copy_obj(current) \
                if gvk.kind in ("ResourceQuota", "Pod") else None
            self._apply_patch(current, patch, patch_type)
            if rollback is not None:
                try:
                    if gvk.kind == "ResourceQuota":
                        self._validate_quota(current)
                    else:
                        self._validate_pod_quantities(current)
                        self._admit_pod_change(current, rollback)
                except errors.ApiError:
                    current.clear()
                    current.update(rollback)
                    raise
            self._bump(current)
            # Same terminating-object rule as update(): stripping the last
            # finalizer from a deletionTimestamp'd object deletes it.
            if meta(current).get("deletionTimestamp") and not meta(current).get("finalizers"):
                key = _key(gvk, namespace if gvk.namespaced else None, name)
                del self._objects[key]
                self._emit("DELETED", current)
                self._cascade(meta(current).get("uid"))
                if gvk.kind == "Pod":
                    self._requota(namespace)
                return _copy_obj(current)
            self._emit("MODIFIED", current)
            if gvk.kind in ("Pod", "ResourceQuota"):
                self._requota(namespace)
            return _copy_obj(current)

    @staticmethod
    def _apply_patch(current: Resource, patch, patch_type: str) -> None:
        """Apply one patch flavor to ``current`` in place (shared by patch
        and patch_status)."""
        if patch_type == "merge" or patch_type == "strategic":
            from kubeflow_tpu_torch.platform import native

            # loaded(), not available(): never a first build under the
            # store's lock.  The engines are held equal by the tests.
            if native.loaded():
                merged = native.merge_patch_apply(current, patch)
                current.clear()
                current.update(merged)
            else:
                _merge_patch(current, patch)
        elif patch_type == "json":
            from kubeflow_tpu_torch.platform.webhook.jsonpatch import apply_patch

            patched = apply_patch(_copy_obj(current), patch)
            current.clear()
            current.update(patched)
        else:
            raise errors.BadRequest(f"unsupported patch type {patch_type}")

    def patch_status(self, gvk, name, patch, namespace=None, *,
                     patch_type="merge") -> Resource:
        """PATCH on the /status subresource: only the status stanza of the
        patched result persists — spec/metadata edits smuggled into a
        status patch are discarded (the apiserver's subresource isolation,
        mirroring how update_status keeps spec)."""
        with self._lock:
            patch = _copy_obj(patch)
            current = self._get_ref(gvk, name, namespace)
            staging = _copy_obj(current)
            self._apply_patch(staging, patch, patch_type)
            if "status" in staging:
                current["status"] = staging["status"]
            else:
                current.pop("status", None)
            self._bump(current)
            self._emit("MODIFIED", current)
            if gvk.kind == "Pod":
                # Terminal phases (Succeeded/Failed) release quota.
                self._requota(namespace_of(current))
            return _copy_obj(current)

    def delete(self, gvk, name, namespace=None, *, propagation="Background") -> None:
        with self._lock:
            obj = self._get_ref(gvk, name, namespace)
            key = _key(gvk, namespace if gvk.namespaced else None, name)
            # Finalizer semantics: mark for deletion, keep the object until
            # controllers strip their finalizers (via update()).
            if meta(obj).get("finalizers"):
                if not meta(obj).get("deletionTimestamp"):
                    meta(obj)["deletionTimestamp"] = self._timestamp()
                    self._bump(obj)
                    self._emit("MODIFIED", obj)
                return
            del self._objects[key]
            self._emit("DELETED", obj)
            self._cascade(meta(obj).get("uid"))
            if gvk.kind == "Pod":
                self._requota(namespace)

    def _cascade(self, owner_uid: Optional[str]) -> None:
        if not owner_uid:
            return
        doomed = []
        for key, obj in self._objects.items():
            for ref in meta(obj).get("ownerReferences", []):
                if ref.get("uid") == owner_uid:
                    doomed.append((key, obj))
                    break
        for key, obj in doomed:
            if key in self._objects:
                del self._objects[key]
                self._emit("DELETED", obj)
                self._cascade(meta(obj).get("uid"))
                if gvk_of(obj).kind == "Pod":
                    self._requota(namespace_of(obj))

    def watch(self, gvk, namespace=None, *, resource_version=None,
              label_selector=None, shard_filter=None,
              stop: Optional[threading.Event] = None
              ) -> Iterator[Tuple[str, Resource]]:
        """NOT a generator: the watcher registers at CALL time, atomically
        (same lock) with the backlog snapshot — a lazy generator would only
        register at first next(), and every event between the caller's LIST
        and that first next() would be lost (the informer's relist→watch
        gap; a real apiserver replays that window from etcd, which is what
        ``resource_version`` resume does here via the event history).  A
        resume older than the retained window yields a single 410-style
        ERROR event and ends, like a compacted etcd — callers relist.

        ``shard_filter`` (a ShardFilter spec string) scopes the stream
        server-side: backlog, history replay and live events are all
        filtered through it, so a re-subscribe after a shard move
        replays the moved range's history under the NEW subscription."""
        filt = ShardFilter.parse(shard_filter) if isinstance(
            shard_filter, str) else shard_filter
        q: queue.Queue = queue.Queue()
        entry = (gvk, namespace, label_selector, filt, q)
        with self._lock:
            if resource_version is None:
                # List+watch semantics: current state first.
                backlog = [
                    ("ADDED", obj) for obj in self.list(
                        gvk, namespace, label_selector=label_selector,
                        shard_filter=filt)
                ]
            else:
                try:
                    since = int(resource_version)
                except (TypeError, ValueError):
                    since = -1
                if since < self._history_floor:
                    def gone() -> Iterator[Tuple[str, Resource]]:
                        yield ("ERROR", {
                            "kind": "Status", "apiVersion": "v1",
                            "status": "Failure", "reason": "Expired",
                            "code": 410,
                            "message": "too old resource version: "
                                       f"{resource_version}",
                        })
                    return gone()
                backlog = []
                for rv_int, etype, ref in self._history:
                    if rv_int <= since:
                        continue
                    ogvk = gvk_of(ref)
                    if (ogvk.kind != gvk.kind
                            or ogvk.api_version != gvk.api_version):
                        continue
                    if (gvk.namespaced and namespace
                            and namespace_of(ref) != namespace):
                        continue
                    if label_selector and not match_labels(
                            ref, label_selector):
                        continue
                    if filt is not None and not filt.admits(ref):
                        continue
                    backlog.append((etype, _copy_obj(ref)))
            self._watchers.append(entry)
        return self._watch_stream(entry, backlog, stop)

    def _watch_stream(self, entry, backlog, stop) -> Iterator[Tuple[str, Resource]]:
        q = entry[4]
        try:
            for evt in backlog:
                yield evt
            while stop is None or not stop.is_set():
                try:
                    yield q.get(timeout=0.1)
                except queue.Empty:
                    continue
        finally:
            with self._lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

    def can_i(self, user, verb, gvk, namespace=None, *, groups=None, subresource="") -> bool:
        if self.authz_policy is None:
            return True
        return self.authz_policy(
            user=user, verb=verb, gvk=gvk, namespace=namespace,
            groups=groups or [], subresource=subresource,
        )

    def pod_logs(self, name, namespace, *, container=None) -> str:
        self._get_ref(POD, name, namespace)  # NotFound if the pod is gone
        return self._pod_logs.get((namespace, name, container)) or \
            self._pod_logs.get((namespace, name, None), "")

    # -- internals -----------------------------------------------------------

    def _quota_refs(self, ns: str) -> List[Resource]:
        from kubeflow_tpu_torch.platform.k8s.types import RESOURCEQUOTA

        return [obj for (_, _, objns, _), obj
                in self._objects.kind_items(RESOURCEQUOTA) if objns == ns]

    def _pod_refs(self, ns: str) -> List[Resource]:
        return [obj for (_, _, objns, _), obj
                in self._objects.kind_items(POD) if objns == ns]

    def _admit_pod_quota(self, pod: Resource, ns: str):
        """Quota admission plugin: deny a pod that would exceed any
        ResourceQuota in its namespace, with the apiserver's phrasing.
        Returns the namespace's live usage totals (pre-pod) so create()
        can reuse them for the status refresh, or None if no quotas."""
        quotas = self._quota_refs(ns)
        if not quotas:
            return None
        # Recompute live usage rather than trusting status.used, exactly as
        # the real plugin re-lists on admission — a quota created a moment
        # ago must enforce against pods that predate it.
        totals = quota_mod.live_usage(self._pod_refs(ns))
        violation = quota_mod.find_violation(
            quotas, quota_mod.pod_quota_usage(pod),
            used_override={name_of(q): totals for q in quotas},
        )
        if violation is not None:
            raise errors.Forbidden(
                f'pods "{name_of(pod)}" is forbidden: {violation.message()}'
            )
        return totals

    def _validate_pod_quantities(self, pod: Resource) -> None:
        """Typed rejection for malformed container quantities (the real
        apiserver validates at create) — one stored junk pod must never
        poison every later quota computation in its namespace."""
        for section in ("containers", "initContainers"):
            for c in deep_get(pod, "spec", section, default=[]) or []:
                res = c.get("resources") or {}
                for flavor in ("requests", "limits"):
                    for key, val in (res.get(flavor) or {}).items():
                        try:
                            quota_mod.parse_quantity(val)
                        except (ValueError, TypeError):
                            raise errors.Invalid(
                                f'pods "{name_of(pod)}" is invalid: '
                                f'{flavor}.{key}: invalid quantity {val!r}'
                            ) from None

    def _admit_pod_change(self, new_pod: Resource, old_pod: Resource) -> None:
        """Quota admission for a pod UPDATE/PATCH (in-place resize): only
        the usage delta vs the stored pod is charged."""
        ns = namespace_of(new_pod)
        quotas = self._quota_refs(ns)
        if not quotas:
            return
        old = quota_mod.pod_quota_usage(old_pod)
        new = quota_mod.pod_quota_usage(new_pod)
        delta = {k: v - old.get(k, 0.0) for k, v in new.items()
                 if v - old.get(k, 0.0) > 0}
        if not delta:
            return
        totals = quota_mod.live_usage(self._pod_refs(ns))
        violation = quota_mod.find_violation(
            quotas, delta,
            used_override={name_of(q): totals for q in quotas},
        )
        if violation is not None:
            raise errors.Forbidden(
                f'pods "{name_of(new_pod)}" is forbidden: '
                f'{violation.message()}'
            )

    def _validate_quota(self, obj: Resource) -> None:
        """Reject malformed spec.hard at write time (the real apiserver
        does) — a typo'd quantity must not crash later pod admissions."""
        try:
            quota_mod.validate_hard(
                deep_get(obj, "spec", "hard", default={}) or {})
        except ValueError as e:
            raise errors.Invalid(
                f'ResourceQuota "{name_of(obj)}" is invalid: {e}'
            ) from None

    def _requota(self, ns: str, *,
                 totals: Optional[Dict[str, float]] = None) -> None:
        """Refresh status.used/hard on every ResourceQuota in `ns`."""
        quotas = self._quota_refs(ns)
        if not quotas:
            return
        for q, used in quota_mod.quota_status(
                quotas, self._pod_refs(ns) if totals is None else (),
                totals=totals):
            fresh = {
                "hard": dict(deep_get(q, "spec", "hard", default={}) or {}),
                "used": used,
            }
            if q.get("status") != fresh:
                q["status"] = fresh
                self._bump(q)
                self._emit("MODIFIED", q)

    def _check_rv(self, incoming: Resource, current: Resource) -> None:
        rv = meta(incoming).get("resourceVersion")
        if rv and rv != meta(current).get("resourceVersion"):
            raise errors.Conflict(
                f'operation cannot be fulfilled: object was modified '
                f'(have {rv}, current {meta(current).get("resourceVersion")})'
            )

    def _timestamp(self) -> str:
        import datetime

        return datetime.datetime.fromtimestamp(
            self._now(), tz=datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%SZ")

    # -- test fixtures -------------------------------------------------------

    def add_namespace(self, name: str, *, labels: Optional[dict] = None) -> Resource:
        return self.create(
            {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": name, **({"labels": labels} if labels else {})}}
        )

    def add_gpu_node(self, name: str, *, accelerator: str = "h100-80gb",
                     gpus: Optional[int] = None) -> Resource:
        """Fake GPU node: the product and count labels NVIDIA's GPU
        feature discovery writes and ``nvidia.com/gpu`` capacity, what
        ``gpu/topology.py`` scans (``gpus`` defaults to the accelerator's
        full host)."""
        from kubeflow_tpu_torch.platform.gpu import (
            ACCELERATORS,
            LABEL_GPU_COUNT,
            LABEL_GPU_PRODUCT,
            RESOURCE_GPU,
        )

        acc = ACCELERATORS[accelerator]
        gpus = acc.gpus_per_host if gpus is None else gpus
        return self.create({
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {
                "name": name,
                "labels": {LABEL_GPU_PRODUCT: acc.product,
                           LABEL_GPU_COUNT: str(gpus)},
            },
            "status": {
                "capacity": {RESOURCE_GPU: str(gpus), "cpu": "208",
                             "memory": "1800Gi"},
                "allocatable": {RESOURCE_GPU: str(gpus)},
            },
        })

    def set_pod_logs(self, namespace: str, name: str, logs: str,
                     *, container: Optional[str] = None) -> None:
        """Stub the kubelet log endpoint for a pod (container=None is the
        default-container fallback)."""
        self._pod_logs[(namespace, name, container)] = logs

    def set_pod_phase(self, namespace: str, name: str, phase: str, *,
                      ready: Optional[bool] = None,
                      conditions: Optional[list] = None) -> Resource:
        """Simulate the kubelet moving a pod through its lifecycle."""
        pod = self.get(POD, name, namespace)
        status = pod.setdefault("status", {})
        status["phase"] = phase
        if conditions is not None:
            status["conditions"] = conditions
        elif ready is not None:
            status["conditions"] = [
                {"type": "Ready", "status": "True" if ready else "False",
                 "lastTransitionTime": self._timestamp()}
            ]
        return self.update_status(pod)


def _merge_patch(target: Resource, patch: Any) -> None:
    """RFC 7386 merge patch, in place."""
    if not isinstance(patch, dict):
        raise errors.BadRequest("merge patch must be an object")
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict):
            if not isinstance(target.get(k), dict):
                # RFC 7386: patching a non-object target applies the patch
                # to {} — nulls nested inside the patch value are removal
                # markers there too, never stored literally.
                target[k] = {}
            _merge_patch(target[k], v)
        else:
            target[k] = _copy_obj(v)


def _match_fields(obj: Resource, field_selector: Dict[str, str]) -> bool:
    """Dotted-path equality, the fieldSelector subset real servers support."""
    for path, want in field_selector.items():
        value = deep_get(obj, *path.split("."))
        if value is None or str(value) != str(want):
            return False
    return True
