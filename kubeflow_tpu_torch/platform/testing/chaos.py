"""ChaosKube: deterministic fault injection in front of any KubeClient.
The port's copy of ``kubeflow_tpu/platform/testing/chaos.py``.

Resilience only exists once failure is injectable and REPEATABLE;
client-go's test suite injects flaky watches and throttling the same
way.  This wrapper implements the ``KubeClient`` protocol around any
inner client (``FakeKube`` in the tests) and injects faults from a
seeded schedule:

* ``429`` TooManyRequests with a ``Retry-After``
* ``500`` / ``503`` server errors
* ``timeout`` (TransportError — the request never got a response)
* ``latency`` (sleep, then delegate — slow apiserver, not a broken one)
* ``409`` write conflicts
* ``410`` Gone / expired resourceVersion at watch establishment
* ``drop`` / ``drop_error`` — mid-stream watch cuts (clean end of the
  stream vs a transport exception), evaluated per delivered event

Faults are per-verb and per-GVK selectable (``Fault.verbs`` /
``Fault.kinds``) and every injection and every call is logged
(``fault_log`` / ``calls``), and every write call with its key and time
(``write_log``, the wire log ``testing/shardfleet.py`` joins against
the fence's), so tests assert "the storm actually stormed" and "the
informer resumed by RV instead of relisting".

Determinism: one seeded ``random.Random`` behind a lock — given the same
call sequence the same faults fire, the reference's schedule draw for
draw.  Under multithreaded controllers the call ORDER varies run to run,
so soak tests assert invariants (converged, no duplicates, caches
consistent), not exact fault placement.  The REST client that the
reference also storms over a wire is not ported: here ``ChaosKube`` is
the controller's client itself.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    GVK,
    Resource,
    gvk_of,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.platform.runtime.sharding import WRITE_VERBS

# Fault kinds that apply to the watch STREAM (per delivered event) rather
# than to the call itself.
STREAM_FAULTS = frozenset({"drop", "drop_error"})


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault spec in a chaos schedule.

    ``error``: "429" | "500" | "503" | "409" | "410" | "timeout" |
    "latency" | "drop" | "drop_error".
    ``rate``: probability per eligible call (or per delivered watch event
    for drop/drop_error).
    ``verbs`` / ``kinds``: restrict to these client verbs (get/list/
    create/update/update_status/patch/patch_status/delete/watch/logs/
    can_i) / resource kinds; None = all.
    ``retry_after``: seconds advertised on an injected 429/503.
    ``latency_s``: sleep for "latency" faults.
    ``max_injections``: stop firing after N hits (None = unlimited) —
    lets a soak storm die down so convergence can be asserted.
    """

    error: str
    rate: float
    verbs: Optional[frozenset] = None
    kinds: Optional[frozenset] = None
    retry_after: Optional[float] = None
    latency_s: float = 0.01
    max_injections: Optional[int] = None


def storm(*, rate: float = 0.05, seed_latency: float = 0.002,
          retry_after: float = 0.02,
          max_injections: Optional[int] = None) -> List[Fault]:
    """The standard mixed fault storm: every transient failure class at
    ``rate``, writes additionally conflicting, watches dropping
    mid-stream, so every soak storms the same way."""
    writes = frozenset({"create", "update", "update_status", "patch",
                        "patch_status"})
    return [
        Fault("429", rate, retry_after=retry_after,
              max_injections=max_injections),
        Fault("503", rate, retry_after=retry_after,
              max_injections=max_injections),
        Fault("500", rate / 2, max_injections=max_injections),
        Fault("timeout", rate / 2, max_injections=max_injections),
        Fault("latency", rate * 2, latency_s=seed_latency,
              max_injections=max_injections),
        Fault("409", rate, verbs=writes, max_injections=max_injections),
        Fault("drop", rate * 2, verbs=frozenset({"watch"}),
              max_injections=max_injections),
        Fault("drop_error", rate, verbs=frozenset({"watch"}),
              max_injections=max_injections),
        Fault("410", rate / 2, verbs=frozenset({"watch"}),
              max_injections=max_injections),
    ]


class ChaosKube:
    """KubeClient wrapper injecting faults from a seeded schedule."""

    def __init__(self, inner, faults: Optional[List[Fault]] = None, *,
                 seed: int = 0):
        self.inner = inner
        self.faults = list(faults if faults is not None else storm())
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.enabled = True
        # (verb, fault.error, kind) occurrences, oldest first.
        self.fault_log: List[Tuple[str, str, str]] = []
        # verb -> call count (faulted calls included).
        self.calls: Dict[str, int] = {}
        # (verb, kind) -> call count — the write-path A/B assertions
        # ("fewer Event creates than the pre-patch path") read this.
        self.calls_by_kind: Dict[Tuple[str, str], int] = {}
        # Every WRITE verb call, keyed and timestamped:
        # (monotonic_t, verb, kind, namespace, name), oldest first, faulted
        # calls included (the fault fires AFTER recording — the attempt is
        # the observable).  ShardedFleet joins one ChaosKube per replica
        # against the coordinators' ownership windows to prove the fencing
        # invariant: no key written by two replicas in overlapping
        # ownership windows.
        self.write_log: List[Tuple[float, str, str, str, str]] = []
        # Establishment kwargs per watch() call, for resume assertions.
        self.watch_establishments: List[dict] = []
        self._injections: Dict[int, int] = {}  # fault index -> times fired

    # -- control / assertions ------------------------------------------------

    def pause(self) -> None:
        """Stop injecting (the soak's quiesce phase); logs are kept."""
        self.enabled = False

    def resume(self) -> None:
        self.enabled = True

    def injected(self, error: Optional[str] = None) -> int:
        with self._lock:
            if error is None:
                return len(self.fault_log)
            return sum(1 for _, e, _k in self.fault_log if e == error)

    # -- schedule ------------------------------------------------------------

    # THE write-verb set, shared with the fencing layer: the wire-log
    # join must cover exactly the verbs the FencedClient fences — one
    # definition (runtime/sharding.py) keeps a new write verb from
    # silently escaping either side.
    WRITE_VERBS = WRITE_VERBS

    def _record(self, verb: str, kind: str = "", *,
                namespace: Optional[str] = None,
                name: Optional[str] = None) -> None:
        with self._lock:
            self.calls[verb] = self.calls.get(verb, 0) + 1
            key = (verb, kind)
            self.calls_by_kind[key] = self.calls_by_kind.get(key, 0) + 1
            if verb in self.WRITE_VERBS:
                self.write_log.append(
                    (time.monotonic(), verb, kind, namespace or "",
                     name or ""))

    def _pick(self, verb: str, kind: str, *, stream: bool = False
              ) -> Optional[Fault]:
        """Deterministically decide the fault (if any) for one call/event.
        EVERY eligible fault consumes one RNG draw whether or not it fires,
        so the decision sequence depends only on the call sequence, not on
        which earlier faults happened to fire."""
        if not self.enabled:
            return None
        hit = None
        with self._lock:
            for i, f in enumerate(self.faults):
                if (f.error in STREAM_FAULTS) != stream:
                    continue
                if f.verbs is not None and verb not in f.verbs:
                    continue
                if f.kinds is not None and kind not in f.kinds:
                    continue
                fired = self._rng.random() < f.rate
                if fired and hit is None:
                    if (f.max_injections is not None
                            and self._injections.get(i, 0)
                            >= f.max_injections):
                        continue
                    self._injections[i] = self._injections.get(i, 0) + 1
                    self.fault_log.append((verb, f.error, kind))
                    hit = f
        return hit

    def _inject(self, verb: str, kind: str) -> None:
        """Raise/sleep per the schedule; returns normally when the call
        should proceed to the inner client."""
        f = self._pick(verb, kind)
        if f is None:
            return
        self._raise_fault(f, verb, kind)

    @staticmethod
    def _raise_fault(f: Fault, verb: str, kind: str) -> None:
        msg = f"chaos: injected {f.error} on {verb} {kind}".rstrip()
        if f.error == "latency":
            time.sleep(f.latency_s)
            return
        if f.error == "429":
            raise errors.TooManyRequests(msg, retry_after=f.retry_after)
        if f.error == "500":
            raise errors.InternalError(msg)
        if f.error == "503":
            raise errors.ServiceUnavailable(msg, retry_after=f.retry_after)
        if f.error == "timeout":
            raise errors.TransportError(msg)
        if f.error == "409":
            raise errors.Conflict(msg)
        if f.error == "410":
            raise errors.Gone(msg)
        raise ValueError(f"unknown fault kind {f.error!r}")

    # -- verbs (KubeClient Protocol) -----------------------------------------

    def get(self, gvk: GVK, name: str, namespace: Optional[str] = None
            ) -> Resource:
        self._record("get", gvk.kind)
        self._inject("get", gvk.kind)
        return self.inner.get(gvk, name, namespace)

    def list(self, gvk, namespace=None, *, label_selector=None,
             field_selector=None, shard_filter=None) -> List[Resource]:
        self._record("list", gvk.kind)
        self._inject("list", gvk.kind)
        kwargs = {"label_selector": label_selector,
                  "field_selector": field_selector}
        if shard_filter is not None:
            # Only forwarded when set, so plain test doubles that predate
            # the codec/filter surface keep working as inner clients.
            kwargs["shard_filter"] = shard_filter
        return self.inner.list(gvk, namespace, **kwargs)

    def list_with_rv(self, gvk, namespace=None, *, shard_filter=None):
        self._record("list", gvk.kind)
        self._inject("list", gvk.kind)
        if hasattr(self.inner, "list_with_rv"):
            if shard_filter is not None:
                return self.inner.list_with_rv(gvk, namespace,
                                               shard_filter=shard_filter)
            return self.inner.list_with_rv(gvk, namespace)
        return self.inner.list(gvk, namespace), None

    def create(self, obj: Resource, *, dry_run: bool = False) -> Resource:
        self._record("create", gvk_of(obj).kind,
                     namespace=namespace_of(obj), name=name_of(obj))
        self._inject("create", gvk_of(obj).kind)
        return self.inner.create(obj, dry_run=dry_run)

    def update(self, obj: Resource) -> Resource:
        self._record("update", gvk_of(obj).kind,
                     namespace=namespace_of(obj), name=name_of(obj))
        self._inject("update", gvk_of(obj).kind)
        return self.inner.update(obj)

    def update_status(self, obj: Resource) -> Resource:
        self._record("update_status", gvk_of(obj).kind,
                     namespace=namespace_of(obj), name=name_of(obj))
        self._inject("update_status", gvk_of(obj).kind)
        return self.inner.update_status(obj)

    def patch(self, gvk, name, patch, namespace=None, *,
              patch_type: str = "merge") -> Resource:
        self._record("patch", gvk.kind, namespace=namespace, name=name)
        self._inject("patch", gvk.kind)
        return self.inner.patch(gvk, name, patch, namespace,
                                patch_type=patch_type)

    def patch_status(self, gvk, name, patch, namespace=None, *,
                     patch_type: str = "merge") -> Resource:
        self._record("patch_status", gvk.kind, namespace=namespace,
                     name=name)
        self._inject("patch_status", gvk.kind)
        return self.inner.patch_status(gvk, name, patch, namespace,
                                       patch_type=patch_type)

    def delete(self, gvk, name, namespace=None, *,
               propagation: str = "Background") -> None:
        self._record("delete", gvk.kind, namespace=namespace, name=name)
        self._inject("delete", gvk.kind)
        return self.inner.delete(gvk, name, namespace,
                                 propagation=propagation)

    def can_i(self, user, verb, gvk, namespace=None, *, groups=None,
              subresource: str = "") -> bool:
        self._record("can_i", gvk.kind)
        self._inject("can_i", gvk.kind)
        return self.inner.can_i(user, verb, gvk, namespace,
                                groups=groups, subresource=subresource)

    def pod_logs(self, name, namespace, *, container=None) -> str:
        self._record("logs", "Pod")
        self._inject("logs", "Pod")
        return self.inner.pod_logs(name, namespace, container=container)

    def watch(self, gvk, namespace=None, *, resource_version=None,
              label_selector=None, shard_filter=None,
              stop: Optional[threading.Event] = None
              ) -> Iterator[Tuple[str, Resource]]:
        self._record("watch", gvk.kind)
        with self._lock:
            self.watch_establishments.append({
                "kind": gvk.kind, "namespace": namespace,
                "resource_version": resource_version,
                "shard_filter": shard_filter,
            })
        # Establishment faults (429/503/timeout/410 ...) fire BEFORE the
        # inner watch registers, exactly like a rejected HTTP upgrade.
        self._inject("watch", gvk.kind)
        kwargs = {"resource_version": resource_version,
                  "label_selector": label_selector, "stop": stop}
        if shard_filter is not None:
            kwargs["shard_filter"] = shard_filter
        inner_iter = self.inner.watch(gvk, namespace, **kwargs)

        def stream() -> Iterator[Tuple[str, Resource]]:
            for evt in inner_iter:
                yield evt
                f = self._pick("watch", gvk.kind, stream=True)
                if f is None:
                    continue
                if f.error == "drop":
                    # Clean end of the stream — a bounded watch window
                    # expiring / a LB closing the connection gracefully.
                    # Callers must RESUME from the last RV, not relist.
                    return
                raise errors.TransportError(
                    f"chaos: watch stream on {gvk.kind} dropped")

        return stream()

    # -- passthrough ---------------------------------------------------------

    def __getattr__(self, name):
        # Test fixtures (add_namespace, set_pod_phase, ...) reach the
        # inner store directly; only Protocol verbs get chaos.
        return getattr(self.inner, name)
